"""The port's public API against the JAX package's, name by name.

Both packages are parsed with ``ast`` (neither is imported). For every
module of ``voxtracer/``, each public module-level function, class and
method must have a counterpart of the same name in the port's module of
the same path (``kernels/pallas/*.py`` maps onto
``voxtracer_torch/kernels/*.py``), or a row in ``EXCEPTIONS`` below. A
row is either TPU mechanism that changes no output (the list of
README.md's port section, between its ``not-ported`` markers: the test
holds the two lists equal) or a name whose work the port does under
another name (the row names it, and the port must have it). A row whose
name the JAX package no longer has, or that the port has after all,
fails: the table only lists live gaps. The CLI's flags and sub-commands
are compared the same way.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "voxtracer"
PORT_PKG = REPO / "voxtracer_torch"

# (module path under voxtracer/, public name) -> (kind, reason); kind is
# "mechanism" or "renamed: <port name>"
EXCEPTIONS = {
    ("core/lanes.py", "take_lanes"): (
        "mechanism", "one packed row gather for a wavefront's compaction "
        "on the TPU; the port compacts no wavefront"),
    ("kernels/traverse.py", "svo_raycast_bucketed"): (
        "mechanism", "live-lane compaction between a lockstep cast's "
        "segments; K2's lane fetch retires each ray on its own"),
    ("kernels/raster.py", "fit_near_slots"): (
        "mechanism", "sizes a static capacity of the TPU rasterizer; the "
        "port's bins have none"),
    ("kernels/raster.py", "fit_pair_slots"): (
        "mechanism", "sizes the TPU rasterizer's static pair-sort "
        "capacity; the port's bins have none"),
    ("kernels/raster.py", "fit_widen_tiles"): (
        "mechanism", "sizes the TPU rasterizer's static widen-round "
        "capacity; the port's bins have none"),
    ("utils/profiling.py", "trace"): (
        "mechanism", "the jax.profiler wrapper; torch.profiler and "
        "tools/kernel_ab.py profile_call do its job"),
    ("kernels/raster.py", "pack_box_attr"): (
        "renamed: soup_to_device", "packs [leaf_bits, r, g, b] as part "
        "of the soup's upload"),
    ("kernels/skyline.py", "skyline_env_tmin_traced"): (
        "renamed: skyline_env_tmin_plain", "the traceable body of "
        "skyline_env_tmin is K5's plain version"),
}

# flags and sub-commands of voxtracer/app/cli.py the port's CLI lacks
CLI_EXCEPTIONS = {
    "--bands": ("mechanism", "svo_raycast_bucketed's per-band early "
                "exits on the CLI"),
}

NOT_PORTED = re.compile(r"^- `([\w/]+\.py)` `([-\w.]+)`: \S")


def public_names(source: str) -> dict:
    """{name: kind} of a module's public functions and classes, and of
    its public classes' public methods (as ``Class.method``)."""
    out = {}
    for node in ast.parse(source).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = "function"
        elif isinstance(node, ast.ClassDef):
            out[node.name] = "class"
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and not m.name.startswith("_"):
                    out[f"{node.name}.{m.name}"] = "method"
    return out


def missing_names(jax_src: str, port_src: str | None, module: str,
                  exceptions: dict) -> list:
    """Public names of the JAX module that the port's module lacks and no
    row of ``exceptions`` covers (the port's module may be absent)."""
    have = public_names(port_src) if port_src is not None else {}
    return sorted(n for n in public_names(jax_src)
                  if n not in have and (module, n) not in exceptions)


def stale_rows(jax_names: dict, port_names: dict, exceptions: dict) -> list:
    """Rows that list no live gap: the JAX module lacks the name, the
    port has the name itself, or a rename's target is missing.
    ``jax_names``/``port_names``: {module: {name: kind}}."""
    bad = []
    for (module, name), (kind, reason) in exceptions.items():
        port = port_names.get(module, {})
        target = kind.removeprefix("renamed: ")
        if (name not in jax_names.get(module, {}) or name in port
                or not reason.strip()
                or (kind != "mechanism" and target not in port)):
            bad.append((module, name))
    return bad


def _port_path(module: str) -> Path:
    parts = module.split("/")
    if parts[:2] == ["kernels", "pallas"]:
        parts = ["kernels"] + parts[2:]
    return PORT_PKG.joinpath(*parts)


def _modules():
    return sorted(p.relative_to(JAX_PKG).as_posix()
                  for p in JAX_PKG.rglob("*.py"))


def _read(path: Path):
    return path.read_text() if path.exists() else None


@pytest.mark.parametrize("module", _modules())
def test_module_names_have_counterparts(module):
    jax_src = (JAX_PKG / module).read_text()
    miss = missing_names(jax_src, _read(_port_path(module)), module,
                         EXCEPTIONS)
    assert not miss, (f"{module}: public names with no counterpart in "
                      f"{_port_path(module).relative_to(REPO)}: {miss}")


def test_exception_rows_list_live_gaps():
    modules = {m for m, _ in EXCEPTIONS}
    jax_names = {m: public_names((JAX_PKG / m).read_text())
                 for m in modules if (JAX_PKG / m).exists()}
    port_names = {m: public_names(_read(_port_path(m)) or "")
                  for m in modules}
    assert stale_rows(jax_names, port_names, EXCEPTIONS) == []
    for kind, reason in list(EXCEPTIONS.values()) + list(
            CLI_EXCEPTIONS.values()):
        assert kind == "mechanism" or kind.startswith("renamed: ")
        assert reason.strip()


def _cli_surface(source: str):
    """(flags, sub-commands): the first string argument of every
    ``add_argument`` and ``add_parser`` call of a module."""
    flags, cmds = set(), set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.args and isinstance(node.args[0], ast.Constant):
            if node.func.attr == "add_argument":
                flags.add(node.args[0].value)
            elif node.func.attr == "add_parser":
                cmds.add(node.args[0].value)
    return flags, cmds


def test_cli_flags_and_subcommands_match():
    jf, jc = _cli_surface((JAX_PKG / "app" / "cli.py").read_text())
    tf, tc = _cli_surface((PORT_PKG / "app" / "cli.py").read_text())
    assert jc and jc <= tc, sorted(jc - tc)
    assert len(jf) > 20
    assert sorted(jf - tf - set(CLI_EXCEPTIONS)) == []
    # every row is a live gap
    assert all(f in jf and f not in tf for f in CLI_EXCEPTIONS)


def test_mechanism_rows_are_the_readme_list():
    text = (REPO / "README.md").read_text()
    begin, end = "<!-- not-ported: begin -->", "<!-- not-ported: end -->"
    assert text.count(begin) == 1 and text.count(end) == 1
    block = text.split(begin)[1].split(end)[0]
    listed = set()
    for line in block.strip().splitlines():
        if line.startswith("- "):
            m = NOT_PORTED.match(line)
            assert m, line
            listed.add((m.group(1), m.group(2)))
    rows = {k for k, (kind, _) in EXCEPTIONS.items() if kind == "mechanism"}
    rows |= {("app/cli.py", f) for f, (kind, _) in CLI_EXCEPTIONS.items()
             if kind == "mechanism"}
    assert listed == rows, (sorted(listed - rows), sorted(rows - listed))


_JAX_SYNTH = '''
def kept(x):
    return x
def dropped(x):
    return x
def _private(x):
    return x
class Space:
    def get(self):
        pass
    def lost(self):
        pass
'''
_PORT_SYNTH = '''
def kept(x):
    return x
class Space:
    def get(self):
        pass
'''


def test_check_reports_a_missing_name():
    """The check can fail: a port module without ``dropped`` and
    ``Space.lost`` is reported with both, and a row covers one."""
    assert missing_names(_JAX_SYNTH, _PORT_SYNTH, "m.py", {}) == [
        "Space.lost", "dropped"]
    assert missing_names(_JAX_SYNTH, None, "m.py", {}) == [
        "Space", "Space.get", "Space.lost", "dropped", "kept"]
    rows = {("m.py", "dropped"): ("mechanism", "a reason")}
    assert missing_names(_JAX_SYNTH, _PORT_SYNTH, "m.py", rows) == [
        "Space.lost"]
    assert missing_names(_JAX_SYNTH, _JAX_SYNTH, "m.py", {}) == []


def test_check_reports_a_stale_row():
    jax_names = {"m.py": public_names(_JAX_SYNTH)}
    port_names = {"m.py": public_names(_PORT_SYNTH)}
    rows = {
        ("m.py", "dropped"): ("mechanism", "live"),
        ("m.py", "Space.lost"): ("renamed: kept", "live"),
        ("m.py", "gone"): ("mechanism", "the JAX module has no such name"),
        ("m.py", "kept"): ("mechanism", "the port has it after all"),
        ("m.py", "Space.get"): ("renamed: nowhere", "no such target"),
        ("m.py", "Space"): ("mechanism", " "),
    }
    assert sorted(stale_rows(jax_names, port_names, rows)) == [
        ("m.py", "Space"), ("m.py", "Space.get"), ("m.py", "gone"),
        ("m.py", "kept")]
