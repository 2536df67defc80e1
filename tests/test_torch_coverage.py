"""Every module of the JAX package has its counterpart in the port: each
public top-level function, class and UPPER_CASE constant of
``ich_tpu/**.py`` (read with ``ast``, nothing imported) is bound under the
same name in the port's module of the same path, or under the name that
``RENAMED`` gives it, or is on ``NOT_NEEDED``, the list of what the port
does not need (``ROADMAP.md`` §1, "Not ported"). Every ``ich_tpu`` module
that ``docs/PARITY.md`` names in its right-hand column has a port
module."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "ich_tpu", ROOT / "ich_tpu_torch"

# JAX module -> the port's module of another path
MODULE_MAP = {
    "ops/pallas_edt.py": "ops/edt.py",
    "train/checkpoint_orbax.py": "train/checkpoint_sharded.py",
}
# (JAX module, name) -> the port's name for it, in the counterpart module
RENAMED = {
    ("models/layers.py", "Norm"): "make_norm",
    ("models/layers.py", "UpConv"): "up_conv",
    ("train/state.py", "create_train_state"): "TrainState",
    ("parallel/mesh.py", "initialize_multihost"): "init_distributed",
    ("utils/rng.py", "dropout_key"): "rbg_key",
    ("utils/rng.py", "seed_everything"): "prng_key",
    ("ops/pallas_edt.py", "distance_transform_edt_pallas"): "distance_transform_edt_kernel",
}
# a module (every name in it) or (module, name) -> why the port does not
# need it; the first word in backquotes is the one ROADMAP.md's list names
NOT_NEEDED = {
    "utils/cache.py": "`utils/cache.py` is XLA's compile cache",
    "ops/fastconv.py": "`ops/fastconv.py` packs small-channel convs into the TPU's MXU lanes",
    "interop/torch_port.py": "`interop/torch_port.py` maps torch keys to flax; the port "
                             "goes the other way (`interop/from_jax.py`)",
    ("models/layers.py", "PConv"): "`PConv` is the lane-packed conv of `ops/fastconv.py`",
    ("models/layers.py", "FlatGroupNorm"): "`FlatGroupNorm` is a TPU layout of GroupNorm; "
                                           "the port uses torch's fused `group_norm`",
    ("ops/warp.py", "affine_warp_matmul"): "`affine_warp_matmul` is the warp on the MXU; "
                                           "the port warps by an exact gather",
    ("ops/warp.py", "inplane_warp_matmul"): "`affine_warp_matmul`'s in-plane case",
    ("ops/warp.py", "mask_warp_method"): "`*_warp_method` routes the TPU warp",
    ("ops/warp.py", "image_warp_method"): "`*_warp_method` routes the TPU warp",
    ("parallel/mesh.py", "batch_sharding"): "`batch_sharding` is a jax.sharding helper; "
                                            "the port shards with `shard_batch`",
    ("parallel/mesh.py", "replicated_sharding"): "`replicated_sharding` is a jax.sharding "
                                                 "helper; the port has `replicate`",
    ("parallel/sharded_inference.py", "shard_map_fn"): "`shard_map_fn` wraps jax's "
                                                       "`shard_map`",
    ("utils/profiling.py", "StepTimer"): "`StepTimer` synchronised the card every step; "
                                         "the port's steps are timed by the benchmark's "
                                         "windows and read from `torch.profiler` ranges",
}
UPPER = re.compile(r"[A-Z][A-Z0-9_]*")


def public_names(path: Path) -> list:
    """The public top-level functions, classes and UPPER_CASE constants
    that ``path`` defines."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names += [t.id for t in targets
                      if isinstance(t, ast.Name) and UPPER.fullmatch(t.id)]
    return [n for n in names if not n.startswith("_")]


def bound_names(path: Path) -> set:
    """Every name that ``path`` binds at its top level, under an ``if`` or
    ``try`` too: definitions, assignments and imports."""
    names = set()
    for top in ast.parse(path.read_text()).body:
        for node in ast.walk(top) if isinstance(top, (ast.If, ast.Try)) else [top]:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names |= {(a.asname or a.name).split(".")[0] for a in node.names}
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return names


def missing_counterparts(jax_pkg: Path, port_pkg: Path, module_map=None, renamed=None,
                         not_needed=None) -> list:
    """``module:name`` of every public name of ``jax_pkg`` that has no
    counterpart in ``port_pkg`` (``module`` alone where the port lacks the
    whole module)."""
    module_map, renamed, not_needed = module_map or {}, renamed or {}, not_needed or {}
    missing = []
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = path.relative_to(jax_pkg).as_posix()
        if rel in not_needed:
            continue
        names = [n for n in public_names(path) if (rel, n) not in not_needed]
        port = port_pkg / module_map.get(rel, rel)
        if not port.exists():
            missing.append(rel)
            continue
        bound = bound_names(port)
        missing += [f"{rel}:{n}" for n in names if renamed.get((rel, n), n) not in bound]
    return missing


def parity_modules(parity_md: str) -> set:
    """The dotted ``ich_tpu`` paths that the right-hand column of the
    tables of ``parity_md`` names."""
    found = set()
    for line in parity_md.splitlines():
        cells = line.strip().strip("|").split("|")
        if line.lstrip().startswith("|") and len(cells) >= 2:
            found |= set(re.findall(r"\bich_tpu(?:\.\w+)+", cells[-1]))
    return found


def module_of(dotted: str, pkg: Path):
    """The module file of the longest prefix of ``dotted`` (``ich_tpu.a.b.c``)
    that is a module or package under ``pkg``, as a path relative to it."""
    parts = dotted.split(".")[1:]
    for n in range(len(parts), 0, -1):
        base = pkg.joinpath(*parts[:n])
        if base.with_suffix(".py").exists():
            return base.with_suffix(".py").relative_to(pkg).as_posix()
        if (base / "__init__.py").exists():
            return (base / "__init__.py").relative_to(pkg).as_posix()
    return "__init__.py"


def test_every_public_name_has_a_counterpart():
    assert missing_counterparts(JAX_PKG, PORT_PKG, MODULE_MAP, RENAMED, NOT_NEEDED) == []


def test_the_maps_name_what_is_there():
    """No entry outlives its name: each renamed or unneeded name is still
    defined by the JAX package, each port name of ``RENAMED`` and
    ``MODULE_MAP`` exists."""
    for rel, port_rel in MODULE_MAP.items():
        assert (JAX_PKG / rel).exists() and (PORT_PKG / port_rel).exists(), rel
    for (rel, name), port_name in RENAMED.items():
        assert name in public_names(JAX_PKG / rel), (rel, name)
        assert port_name in bound_names(PORT_PKG / MODULE_MAP.get(rel, rel)), port_name
    for entry in NOT_NEEDED:
        if isinstance(entry, str):
            assert (JAX_PKG / entry).exists(), entry
        else:
            assert entry[1] in public_names(JAX_PKG / entry[0]), entry


def test_what_is_not_needed_is_on_the_roadmap_list():
    """Each reason's first name in backquotes stands in ``ROADMAP.md`` §1's
    list of what the port does not need."""
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Not ported")
    listed = text[start:text.index("\n### ", start)]
    for entry, reason in NOT_NEEDED.items():
        name = re.search(r"`([^`]+)`", reason).group(1)
        assert name in listed, (entry, name)


def test_every_module_of_the_parity_map_has_a_port_module():
    named = parity_modules((ROOT / "docs" / "PARITY.md").read_text())
    assert "ich_tpu.ops.ct.window_ct" in named and "ich_tpu.ops.pallas_edt" in named
    for dotted in sorted(named):
        rel = module_of(dotted, JAX_PKG)
        assert (JAX_PKG / rel).exists(), dotted
        if rel not in NOT_NEEDED:
            assert (PORT_PKG / MODULE_MAP.get(rel, rel)).exists(), dotted


def _tree(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return root


JAX_TREE = {
    "__init__.py": "",
    "ops/__init__.py": "",
    "ops/a.py": "import numpy as np\nLIMIT = 3\n_hidden = 1\n\n"
                "def f(x):\n    return x\n\n\nclass K:\n    pass\n\n\ndef _private():\n    pass\n",
    "ops/tpu.py": "def packed():\n    pass\n",
    "train/b.py": "def make_state():\n    pass\n",
}
PORT_TREES = {
    "complete": ({"ops/a.py": "from .c import f\nLIMIT = 3\n\n\nclass K:\n    pass\n",
                  "train/state.py": "class State:\n    pass\n"}, []),
    "a_name_missing": ({"ops/a.py": "LIMIT = 3\n\n\nclass K:\n    pass\n",
                        "train/state.py": "class State:\n    pass\n"}, ["ops/a.py:f"]),
    "a_constant_missing": ({"ops/a.py": "def f():\n    pass\n\n\nclass K:\n    pass\n",
                            "train/state.py": "class State:\n    pass\n"}, ["ops/a.py:LIMIT"]),
    "a_module_missing": ({"ops/a.py": "LIMIT = 3\nf = K = None\n"}, ["train/b.py"]),
    "a_rename_missing": ({"ops/a.py": "LIMIT = 3\nf = K = None\n",
                          "train/state.py": "def make_state():\n    pass\n"},
                         ["train/b.py:make_state"]),
}


@pytest.mark.parametrize("case", sorted(PORT_TREES))
def test_a_synthetic_pair_of_trees(case, tmp_path):
    """The check on a pair of small trees: the port's ``__init__.py`` files
    and ``ops/tpu.py`` are missing; ``ops/tpu.py`` is not needed, and
    ``train/b.py`` is ``train/state.py`` there, its ``make_state`` named
    ``State``. Each tree with a counterpart missing fails, and names it."""
    jax_pkg = _tree(tmp_path / "jax_pkg", JAX_TREE)
    port_files, want = PORT_TREES[case]
    port_pkg = _tree(tmp_path / "port_pkg", {"__init__.py": "", "ops/__init__.py": "",
                                             **port_files})
    got = missing_counterparts(jax_pkg, port_pkg, {"train/b.py": "train/state.py"},
                               {("train/b.py", "make_state"): "State"},
                               {"ops/tpu.py": "a TPU kernel's packing"})
    assert got == want
    # without the maps, the rename and the unneeded module count as missing
    bare = missing_counterparts(jax_pkg, port_pkg)
    assert "ops/tpu.py" in bare and "train/b.py" in bare


def test_a_parity_map_naming_a_module_without_a_port_fails(tmp_path):
    jax_pkg = _tree(tmp_path / "jax_pkg", JAX_TREE)
    port_pkg = _tree(tmp_path / "port_pkg", {"__init__.py": "", "ops/__init__.py": "",
                                             "ops/a.py": ""})
    doc = ("| Reference | ich_tpu |\n|---|---|\n| `f` (`x.py:1`) | `ich_tpu.ops.a.f` |\n"
           "| `make_state` | `ich_tpu.train.b.make_state` (see `ich_tpu.ops.tpu`) |\n"
           "All in `ich_tpu.nowhere`, outside a table.\n")
    named = parity_modules(doc)
    assert named == {"ich_tpu.ops.a.f", "ich_tpu.train.b.make_state", "ich_tpu.ops.tpu"}
    rels = {module_of(d, jax_pkg) for d in named}
    assert rels == {"ops/a.py", "train/b.py", "ops/tpu.py"}
    assert sorted(r for r in rels if not (port_pkg / r).exists()) == ["ops/tpu.py",
                                                                      "train/b.py"]
