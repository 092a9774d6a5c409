"""The reference's own test cases, run against the port on the CPU.

`load(name, namespace, left_out)` reads `tests/<name>.py` (a test file of
the JAX package, never edited), rewrites its `import` / `from ... import`
statements with `ast` so that they name the port's modules, and execs the
result into the namespace of a `tests/test_torch_<stem>.py` file, one port
file per reference file (so that `--dist loadfile` spreads them).  The
rewrite (`MODULES`):

- `acoustid_index_tpu[.x]` -> `acoustid_index_tpu_torch[.x]`;
- `acoustid_index_tpu.ops.pallas_lookup` -> the port's `ops.layout`, which
  holds `BLOCK` (the port has no Pallas module);
- `server_fixture` -> this file: its `Server` is the reference fixture's
  own code, run as `python -m acoustid_index_tpu_torch.main` with
  `AITPU_TORCH_DEVICE=cpu`;
- `test_replication` -> `test_torch_replication` (the edge cases share its
  `Node`).

Cases that test what the port leaves out by design are named, each with its
reason, in the port file's `LEFT_OUT` literal; the tests below hold every
port file to its reference file.  The reference's assertions are rewritten
by pytest's own assertion rewriter, so failures read as in the reference.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

os.environ.setdefault("AITPU_TORCH_DEVICE", "cpu")

MODULES = {
    "acoustid_index_tpu.ops.pallas_lookup": "acoustid_index_tpu_torch.ops.layout",
    "acoustid_index_tpu": "acoustid_index_tpu_torch",
    "server_fixture": "test_torch_refcases",
    "test_replication": "test_torch_replication",
}

# reference file -> its port file
PORTED = {
    "test_file_coordinator": "test_torch_file_coordinator",
    "test_replication": "test_torch_replication",
    "test_replicator_edge": "test_torch_replicator_edge",
    "test_cluster": "test_torch_cluster",
    "test_http_api": "test_torch_http_api",
    "test_misc_parity": "test_torch_misc_parity",
    "test_review_fixes": "test_torch_review_fixes",
    "test_engine": "test_torch_engine",
    "test_bulk_ingest": "test_torch_bulk_ingest",
    "test_wire_bytes": "test_torch_wire_bytes",
    "test_metrics": "test_torch_metrics",
    "test_native": "test_torch_native",
    "test_searcher_pipeline": "test_torch_searcher_pipeline",
    "test_batching": "test_torch_batching",
    "test_abandoned_work": "test_torch_abandoned_work",
    "test_superset_serving": "test_torch_superset_serving",
}


def _port_name(name: str) -> str:
    for old in sorted(MODULES, key=len, reverse=True):
        if name == old or name.startswith(old + "."):
            return MODULES[old] + name[len(old):]
    return name


def rewritten(name: str, strings: dict[str, str] | None = None) -> tuple[ast.Module, str, str]:
    """(tree, source, path) of tests/<name>.py with every import renamed by
    MODULES; `strings` also swaps whole string constants."""
    path = os.path.join(TESTS, name + ".py")
    with open(path) as f:
        source = f.read()
    tree = ast.parse(source, path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname is None and _port_name(alias.name) != alias.name:
                    raise ValueError(f"{path}:{node.lineno}: `import {alias.name}` binds the reference's name")
                alias.name = _port_name(alias.name)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            node.module = _port_name(node.module)
        elif strings and isinstance(node, ast.Constant) and node.value in strings:
            node.value = strings[node.value]
    return tree, source, path


def imported_modules(tree: ast.Module) -> set[str]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def reference_cases(name: str) -> list[str]:
    with open(os.path.join(TESTS, name + ".py")) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


def _exec(name: str, namespace: dict, strings: dict[str, str] | None = None) -> dict:
    tree, source, path = rewritten(name, strings)
    try:
        from _pytest.assertion.rewrite import rewrite_asserts

        rewrite_asserts(tree, source.encode(), path)
    except ImportError:  # outside pytest: plain asserts
        pass
    exec(compile(tree, path, "exec"), namespace)
    return namespace


def load(name: str, namespace: dict, left_out: dict[str, str]) -> None:
    """Exec tests/<name>.py, imports rewritten, into `namespace` (a port
    test file's globals); the cases in `left_out` are removed."""
    cases = set(reference_cases(name))
    for case, reason in left_out.items():
        if case not in cases or not reason.strip():
            raise ValueError(f"{name}: left-out case {case!r} must be a reference case with a reason")
    keep = {k: namespace[k] for k in ("__name__", "__file__", "__doc__") if k in namespace}
    _exec(name, namespace)
    namespace.update(keep)
    for case in left_out:
        del namespace[case]


# The reference's server fixture, run as the port's CLI on the CPU.
_fixture = _exec("server_fixture", {"__name__": "port_server_fixture", "__file__": os.path.join(TESTS, "server_fixture.py")},
                 strings={"acoustid_index_tpu.main": "acoustid_index_tpu_torch.main"})
post_search = _fixture["post_search"]


class Server(_fixture["Server"]):
    """`python -m acoustid_index_tpu_torch.main` with AITPU_TORCH_DEVICE=cpu."""

    def __init__(self, data_dir, extra_args=(), env_extra=None):
        super().__init__(data_dir, extra_args, {"AITPU_TORCH_DEVICE": "cpu", **(env_extra or {})})


# --- the loader's own tests ---------------------------------------------------


def _port_file(port: str) -> ast.Module:
    with open(os.path.join(TESTS, port + ".py")) as f:
        return ast.parse(f.read())


def _left_out(port: str) -> dict[str, str]:
    for node in _port_file(port).body:
        targets = node.targets if isinstance(node, ast.Assign) else [getattr(node, "target", None)]
        if [getattr(t, "id", None) for t in targets] == ["LEFT_OUT"]:
            return ast.literal_eval(node.value)
    raise AssertionError(f"{port}.py names no LEFT_OUT")


@pytest.mark.parametrize("name", sorted(PORTED) + ["server_fixture"])
def test_rewritten_source_imports_nothing_of_the_reference(name):
    mods = imported_modules(rewritten(name)[0])
    assert not any(m == "acoustid_index_tpu" or m.startswith("acoustid_index_tpu.") for m in mods), mods
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "probes", "server_fixture", "test_replication") for m in mods), mods


@pytest.mark.parametrize("name", sorted(PORTED))
def test_every_case_ported_or_left_out_with_a_reason(name):
    """Each port file loads its reference file, and its cases are the
    reference's minus LEFT_OUT, whose names are reference cases with a
    reason."""
    port = PORTED[name]
    left_out = _left_out(port)
    cases = reference_cases(name)
    assert set(left_out) <= set(cases), set(left_out) - set(cases)
    assert all(isinstance(r, str) and len(r.split()) >= 4 for r in left_out.values()), left_out
    loads = [
        n for n in ast.walk(_port_file(port))
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "load"
        and n.args and isinstance(n.args[0], ast.Constant)
    ]
    assert [n.args[0].value for n in loads] == [name]


def test_loading_leaves_sys_path_and_sys_modules_clean():
    """In a fresh interpreter: loading every reference file adds no entry
    to sys.path and imports no module of the JAX package, no jax, and no
    reference test module under its own name."""
    code = (
        "import sys\n"
        "before = list(sys.path)\n"
        "import test_torch_refcases as rc\n"
        "for name in sorted(rc.PORTED):\n"
        "    rc.load(name, {'__name__': 'x_' + name}, {})\n"
        "assert sys.path == before, (before, sys.path)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('acoustid_index_tpu', 'jax', 'jaxlib', 'probes', 'server_fixture', 'test_replication'))\n"
        "assert not bad, bad\n"
        "print('CLEAN', len(rc.PORTED))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, REPO]), AITPU_TORCH_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0 and f"CLEAN {len(PORTED)}" in r.stdout, r.stderr[-3000:]
