"""The port's public surface against the JAX package's, read from source.

Both packages are parsed with `ast`; neither is imported. Every public
function and class of each `isopoints_tpu` module, every public method of
its classes (and `__init__`), every dataclass or NamedTuple field, every
parameter name of those functions and methods, and every name that an
`__init__.py` re-exports must have a counterpart of the same name in the
port's mirrored module (`isopoints_torch/<same path>`, or the port module
named in `MODULES` for the JAX package's kernel modules). A method may come
from a base class of the port's, in the same module or imported.

What has no counterpart on purpose is listed below, each with its reason:
the Pallas entry wrappers and the XLA tiling knobs, whose CUDA counterparts
exist under other names or change no result; flax's parameter trees and
`init` / `apply`, which `nn.Module` replaces; JAX's PRNG keys, which become
a `torch.Generator` or numbers drawn beforehand; and the renames that the
port made. An entry that no longer matches a gap fails the test, so the
list cannot outgrow the gaps.

Run alone, `python -m pytest tests/test_torch_public_api.py` is the check
that the port covers the JAX package.
"""

import ast
import functools
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "isopoints_tpu", "isopoints_torch"

# the JAX package's kernel modules and the port modules that hold their
# CUDA counterparts
MODULES = {
    "ops/neighbors.py": "ops/knn.py",
    "ops/pallas_knn.py": "ops/knn.py",
    "ops/pallas_mlp.py": "ops/fused_mlp.py",
    "ops/pallas_sampler.py": "ops/fused_sampler.py",
    "ops/pallas_trace.py": "ops/fused_trace.py",
    "rendering/pallas_select.py": "rendering/select.py",
    "rendering/pallas_splat.py": "rendering/splat.py",
    "rendering/pallas_occ_bwd.py": "rendering/occ_bwd.py",
}

_WRAPPER = ("a Pallas entry wrapper: the port's CUDA kernel is launched by "
            "its module's wrapper on CUDA tensors under another name")
_TILING = "an XLA tiling knob, which changes no result"
_PRECISION = "an XLA/Pallas knob: the port's fused MLP takes `precision=`"
_DRAWS = ("the port takes random numbers drawn beforehand instead of a JAX "
          "key (get_visible_iso_points' and compute_loss's signatures)")
_PARALLEL = ("parallel/'s rename: `axis_name` becomes the process group, the "
             "optimizer is the step's own clip + Adam, `tree` a module")

# (module, qualified name) or (module, "qualified name(parameter)")
LEFT_OUT = {
    ("ops/pallas_knn.py", "knn_points_pallas"): _WRAPPER,
    ("rendering/pallas_select.py", "select_candidates_pallas"): _WRAPPER,
    ("rendering/pallas_splat.py", "rasterize_fine_pallas"): _WRAPPER,
    ("rendering/pallas_splat.py", "zbuf_backward_tile_pallas"): _WRAPPER,
    ("rendering/pallas_occ_bwd.py", "occ_backward_pallas_one"): _WRAPPER,
    ("ops/pallas_sampler.py", "make_sampler"): _WRAPPER,
    ("ops/pallas_trace.py", "make_trace_stepper"): _WRAPPER,
    ("ops/native.py", "get_native_lib"): "the port builds its libraries in ops/_build.py",
    ("ops/neighbors.py", "knn_points(block_size)"): _TILING,
    ("ops/raymesh.py", "ray_mesh_intersect(ray_block)"): _TILING,
    ("ops/raymesh.py", "ray_mesh_intersect(face_chunk)"): _TILING,
    ("ops/pallas_mlp.py", "make_fused_sdf_fn(interpret)"): _PRECISION,
    ("ops/pallas_mlp.py", "make_fused_sdf_fn(bf16)"): _PRECISION,
    ("ops/pallas_mlp.py", "make_fused_siren_sdf(interpret)"): _PRECISION,
    ("ops/pallas_mlp.py", "make_fused_siren_sdf(bf16)"): _PRECISION,
    ("ops/pallas_mlp.py", "make_fused_igr_sdf(interpret)"): _PRECISION,
    ("ops/pallas_mlp.py", "make_fused_igr_sdf(bf16)"): _PRECISION,
    ("models/combined.py", "CombinedModel.get_visible_iso_points(camera)"): _DRAWS,
    ("models/combined.py", "CombinedModel.get_visible_iso_points(normals)"): _DRAWS,
    ("models/combined.py", "CombinedModel.get_visible_iso_points(spacing)"): _DRAWS,
    ("models/combined.py", "CombinedModel.forward(ray_uniform)"): _DRAWS,
    ("parallel/sharding.py", "make_train_step(image_size)"): _DRAWS,
    ("training/trainer.py", "compute_loss(n_eikonal_points)"): _DRAWS,
    ("training/trainer.py", "compute_loss(axis_name)"): _PARALLEL,
    ("parallel/data.py", "form_global_batch(axis_name)"): _PARALLEL,
    ("parallel/sharding.py", "make_mesh(axis_name)"): _PARALLEL,
    ("parallel/sharding.py", "make_train_step(optimizer)"): _PARALLEL,
    ("parallel/sharding.py", "replicate(tree)"): _PARALLEL,
    ("training/trainer.py", "MVRTrainer.__init__(optimizer)"): _PARALLEL,
    ("training/trainer.py", "TrainState.params"): (
        "flax's parameter tree: the trainer's model holds the parameters"),
    ("training/trainer.py", "MVRTrainer.check_state(state)"): (
        "flax's parameter tree: check_state reads the trainer's model"),
    ("rng.py", "KeyChain"): "renamed GeneratorChain (rng.py)",
    ("debug.py", "capture_grad"): "renamed tap_grad (debug.py)",
    ("utils/mathutils.py", "ndc_to_pix"): "ops/images.ndc_to_pix_coords",
    ("utils/mathutils.py", "pix_to_ndc"): "ops/images.pix_to_ndc_coords",
}

# gaps of a whole kind, each with its reason
FLAX = "flax's parameter tree and init/apply, which nn.Module replaces"
KEY = ("a JAX PRNG key (KeyChain's): the port takes a torch.Generator or "
       "numbers drawn beforehand in its place")


def kind_of(gap):
    """The kind of a gap that a whole rule covers, or None."""
    _, name = gap
    if name.endswith("(params)") or name.split(".")[-1] in ("init()", "apply()"):
        return FLAX
    if name.endswith("(key)"):
        return KEY
    return None


def _parse(pkg, rel):
    path = os.path.join(ROOT, pkg, rel)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return ast.parse(f.read(), path)


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _top(tree):
    """Top-level names: definitions, assignments and imports."""
    out = {}
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out[n.name] = n
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, n)
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.setdefault(n.target.id, n)
        elif isinstance(n, ast.ImportFrom):
            for a in n.names:
                out.setdefault(a.asname or a.name, n)
    return out


def _members(cls):
    """(methods and class attributes, fields) of a class body."""
    methods, fields = {}, []
    for n in cls.body:
        if isinstance(n, ast.FunctionDef):
            methods[n.name] = n
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            fields.append(n.target.id)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    methods.setdefault(t.id, n)
    return methods, fields


def _port_members(rel, cls_node, top):
    """A port class's members with those of its port base classes."""
    methods, fields = _members(cls_node)
    for b in cls_node.bases:
        if not isinstance(b, ast.Name) or b.id not in top:
            continue
        base, base_rel, base_top = top[b.id], rel, top
        if isinstance(base, ast.ImportFrom) and (base.module or "").startswith(PORT_PKG + "."):
            base_rel = base.module[len(PORT_PKG) + 1:].replace(".", "/") + ".py"
            base_top = _top(_parse(PORT_PKG, base_rel))
            base = base_top.get(b.id)
        if isinstance(base, ast.ClassDef):
            m, f = _port_members(base_rel, base, base_top)
            methods, fields = {**m, **methods}, f + fields
    return methods, fields


def _missing_params(jfn, tfn, qual):
    have = set(_params(tfn))
    return [f"{qual}({p})" for p in _params(jfn) if p not in have]


@functools.lru_cache(maxsize=None)
def public_gaps():
    """Every (JAX module, name) of the JAX package with no counterpart in
    the port, and the port's parameter names of each function or method
    whose parameters are missing (to check what took a key's place)."""
    gaps, port_params = [], {}
    base = os.path.join(ROOT, JAX_PKG)
    for dirpath, _, files in sorted(os.walk(base)):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), base).replace(os.sep, "/")
            jtop = _top(_parse(JAX_PKG, rel))
            ttree = _parse(PORT_PKG, MODULES.get(rel, rel))
            assert ttree is not None, f"{rel}: no port module"
            ttop = _top(ttree)
            for name, node in jtop.items():
                if name.startswith("_"):
                    continue
                if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                    # only an __init__.py's imports are its public surface
                    if (fname == "__init__.py" and isinstance(node, ast.ImportFrom)
                            and name not in ttop):
                        gaps.append((rel, name))
                    continue
                if name not in ttop:
                    gaps.append((rel, name))
                    continue
                tnode = ttop[name]
                if isinstance(node, ast.FunctionDef) and isinstance(tnode, ast.FunctionDef):
                    miss = _missing_params(node, tnode, name)
                    gaps += [(rel, m) for m in miss]
                    if miss:
                        port_params[(rel, name)] = _params(tnode)
                if not (isinstance(node, ast.ClassDef) and isinstance(tnode, ast.ClassDef)):
                    continue
                jm, jf = _members(node)
                tm, tf = _port_members(MODULES.get(rel, rel), tnode, ttop)
                gaps += [(rel, f"{name}.{f}") for f in jf
                         if not f.startswith("_") and f not in tf]
                for m, mnode in jm.items():
                    if m.startswith("_") and m != "__init__":
                        continue
                    if m not in tm:
                        gaps.append((rel, f"{name}.{m}()"))
                    elif isinstance(mnode, ast.FunctionDef) and isinstance(tm[m], ast.FunctionDef):
                        miss = _missing_params(mnode, tm[m], f"{name}.{m}")
                        gaps += [(rel, g) for g in miss]
                        if miss:
                            port_params[(rel, f"{name}.{m}")] = _params(tm[m])
    return gaps, port_params


def test_every_public_name_of_the_jax_package_has_a_port():
    gaps, _ = public_gaps()
    unexplained = [g for g in gaps if g not in LEFT_OUT and kind_of(g) is None]
    assert not unexplained, "no counterpart in the port:\n" + "\n".join(
        f"  {rel}: {name}" for rel, name in unexplained)


def test_the_left_out_list_holds_only_gaps():
    """Each entry of LEFT_OUT is a gap that the walk finds, and each rule
    covers at least one: a name that gained a counterpart leaves the list."""
    gaps, _ = public_gaps()
    stale = sorted(set(LEFT_OUT) - set(gaps))
    assert not stale, f"LEFT_OUT entries with a counterpart now: {stale}"
    assert {kind_of(g) for g in gaps} >= {FLAX, KEY}


# JAX functions whose port takes nothing in the key's place: the key is
# never read, or the port draws from a chain seeded elsewhere
_EVAL_TRACE = ("it traces with training False, and then ray_trace draws "
               "nothing (isopoints_tpu/models/raytracing.py:1010-1060)")
KEY_UNREAD = {("data/synthetic.py", "render_view"): _EVAL_TRACE,
              ("models/generator.py", "Generator.raytrace_images"): _EVAL_TRACE,
              ("training/trainer.py", "MVRTrainer.init_state"): (
                  "the trainer draws from its GeneratorChain, seeded by the "
                  "constructor's `seed`")}


def test_a_key_gives_way_to_what_the_port_takes_instead():
    """Where a JAX function takes a PRNG key, its port takes a parameter
    that the JAX one lacks in its place (a generator or drawn numbers),
    unless the key is never read."""
    gaps, port_params = public_gaps()
    jax_params = {}
    for rel, name in gaps:
        if kind_of((rel, name)) is KEY:
            qual = name[:-len("(key)")]
            jtop = _top(_parse(JAX_PKG, rel))
            node = jtop[qual.split(".")[0]]
            if "." in qual:
                node = _members(node)[0][qual.split(".")[1]]
            jax_params[(rel, qual)] = set(_params(node))
    assert len(jax_params) >= 10 and set(KEY_UNREAD) <= set(jax_params)
    for k, jp in jax_params.items():
        if k not in KEY_UNREAD:
            assert set(port_params[k]) - jp, f"{k}: the port takes nothing in the key's place"
        else:
            assert set(port_params[k]) <= jp


def test_the_walk_sees_the_surface():
    """The walk reaches what it should: it finds a method that a port class
    lacks, a missing parameter and a missing re-export, on synthetic
    trees."""
    jax_cls = ast.parse("class C:\n    x: int = 0\n    def f(self, a, b=1): pass\n")
    port_cls = ast.parse("class C:\n    def g(self, a): pass\n")
    jm, jf = _members(jax_cls.body[0])
    tm, tf = _port_members("m.py", port_cls.body[0], _top(port_cls))
    assert jf == ["x"] and "x" not in tf
    assert "f" in jm and "f" not in tm
    assert _missing_params(jm["f"], ast.parse("def f(a): pass").body[0], "C.f") == ["C.f(b)"]
    assert set(_top(ast.parse("from a import b as c\nd = 1\n"))) == {"c", "d"}
