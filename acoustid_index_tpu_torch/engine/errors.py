"""Error taxonomy. Mirrors the reference's error set and its HTTP status
mapping (upstream fpindex's src/server.zig:111-126).

The port's copy of acoustid_index_tpu/engine/errors.py: the same code, its relative
imports resolving to the port's own modules.
"""


class IndexError_(Exception):
    """Base class; `name` is the wire-visible error name."""

    name = "InternalError"
    status = 500


class BadRequest(IndexError_):
    name = "BadRequest"
    status = 400


class InvalidIndexName(IndexError_):
    name = "InvalidIndexName"
    status = 400


class GenerationNotAllowed(IndexError_):
    name = "GenerationNotAllowed"
    status = 400


class InvalidFingerprintId(IndexError_):
    name = "InvalidFingerprintId"
    status = 400


class IndexNotFound(IndexError_):
    name = "IndexNotFound"
    status = 404


class FingerprintNotFound(IndexError_):
    name = "FingerprintNotFound"
    status = 404


class IndexNotReady(IndexError_):
    name = "IndexNotReady"
    status = 503


class SearchTimeout(IndexError_):
    name = "SearchTimeout"
    status = 503


class ReplicationTimeout(IndexError_):
    name = "ReplicationTimeout"
    status = 503


class CoordinatorError(IndexError_):
    name = "CoordinatorError"
    status = 503


class FeedIsReadOnly(IndexError_):
    # 403, not 503: retrying will never make a read-only feed accept a write.
    name = "FeedIsReadOnly"
    status = 403


class VersionMismatch(IndexError_):
    name = "VersionMismatch"
    status = 409


class IndexAlreadyExists(IndexError_):
    name = "IndexAlreadyExists"
    status = 409


class OlderIndexAlreadyExists(IndexError_):
    name = "OlderIndexAlreadyExists"
    status = 409


class NewerIndexAlreadyExists(IndexError_):
    name = "NewerIndexAlreadyExists"
    status = 409


class UnsupportedMediaType(IndexError_):
    name = "UnsupportedMediaType"
    status = 415


class NotImplemented_(IndexError_):
    name = "NotImplemented"
    status = 501


class VersionWentBackwards(IndexError_):
    name = "VersionWentBackwards"
    status = 500


class VersionRequired(IndexError_):
    name = "VersionRequired"
    status = 500


class BelowRetention(IndexError_):
    """Changelog read below the retention floor (HTTP 410 on the coordinator
    protocol); triggers snapshot bootstrap."""

    name = "BelowRetention"
    status = 410
