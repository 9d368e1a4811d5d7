"""PyTorch port: the port does all that the JAX package does, name by name.

Both packages are read with `ast`; neither is imported, so this runs where
only one of them (or neither's dependencies) is installed. One case a
module of `echorenderer_tpu/` (the port's module of the same path must
exist, but for NOT_PORTED_MODULES), and one for each script outside the
package that has a port (SCRIPTS).

Public names are the top-level functions and classes, their public methods
(properties included) and the UPPER-CASE constants. Each must exist in the
port's module of the same path, defined there or imported into it, unless
an exception table says otherwise:
  - NOT_PORTED: names the port is right not to carry, each with its reason;
  - MOVED: names the port keeps in another of its modules, which the test
    checks;
  - RENAMED: parameters that the port renamed or replaced (the new name,
    or None), with the reason.
Every parameter of a public JAX function or method must exist on its port
counterpart, unless RENAMED lists it. KEPT_PRIVATE names private helpers
that the port keeps under the JAX package's names. A case also fails on a
stale entry: a listed name or parameter that the JAX module no longer has,
or one that the port now has in the expected place.

Two reasons are checked by the same reading of the repo's code outside
`tests/` (the JAX package, `tools/`, `benchmarks/` and the top-level
scripts): a name left out as TESTS_ONLY is referenced nowhere there but in
its own definition (or in another TESTS_ONLY name's), and a parameter left
out as NO_CALLER is passed by no call there, but as the same name handed
on.
"""

import ast
import functools
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = "echorenderer_tpu"
PORT_PKG = "echorenderer_tpu_torch"

# scripts outside the JAX package, held to their ports by the same rule
SCRIPTS = {
    "tools/train_denoiser.py": f"{PORT_PKG}/tools/train_denoiser.py",
    "tools/showcase_renders.py": f"{PORT_PKG}/tools/showcase_renders.py",
    "tools/gen_reference_stats.py": f"{PORT_PKG}/tools/gen_reference_stats.py",
    "benchmarks/plucker_micro.py": f"{PORT_PKG}/benchmarks/plucker_micro.py",
}

NOT_PORTED_MODULES = {
    f"{JAX_PKG}/utils/hostmem.py": "a page-fault workaround for the TPU VM's host memory",
}

_KERNEL = "a kernel internal: the Hopper kernel keeps it in csrc/"
TESTS_ONLY = "used only by the JAX package's own tests"
NO_CALLER = "set by no caller; the JAX package keeps it for ablation and debugging only"
NOT_PORTED = {
    **{(f"{JAX_PKG}/utils/vec.py", name): TESTS_ONLY
       for name in ("EPSILON", "dotk", "length", "safe_sqrt", "reflect", "cos_theta",
                    "abs_cos_theta", "cos2_theta", "sin2_theta", "same_hemisphere",
                    "spherical_direction", "transform_point", "transform_direction",
                    "quaternion_to_matrix", "euler_to_quaternion", "kahan_sum")},
    (f"{JAX_PKG}/ops/intersect.py", "ray_sphere"): TESTS_ONLY,
    (f"{JAX_PKG}/utils/colors.py", "BLACK"): TESTS_ONLY,
    (f"{JAX_PKG}/utils/colors.py", "WHITE"): TESTS_ONLY,
    (f"{JAX_PKG}/utils/vec.py", "small_table_lookup"):
        "the MXU one-hot gather, which only beats a slow TPU row gather of a small table; "
        "the port indexes the table",
    (f"{JAX_PKG}/ops/pallas_intersect.py", "RAY_BLOCK"):
        "the Pallas grid's (8, 128) ray tile; the CUDA kernels take WARP rays a ballot",
    (f"{JAX_PKG}/ops/pallas_intersect.py", "PALLAS_PRIM_LIMIT"):
        "the streamed Pallas kernel's VMEM budget; the port's dense kernels take every flat "
        "scene below scene_ops.HIER_TRACE_MIN",
    (f"{JAX_PKG}/ops/pallas_intersect.py", "VMEM_PRIM_LIMIT"):
        "an alias of PALLAS_PRIM_LIMIT, a TPU budget",
    (f"{JAX_PKG}/ops/binned_trace.py", "HB_ENV"):
        "the ECHO_BT_HB switch of a TPU A/B engine; the port keeps the default",
    (f"{JAX_PKG}/parallel/sharding.py", "AXIS"):
        "the name of shard_map's mesh axis; the port's mesh is a list of devices",
    (f"{JAX_PKG}/ops/megakernel.py", "FAT_ROWS"): _KERNEL + " (csrc/megakernel.cu)",
    (f"{JAX_PKG}/ops/megakernel.py", "FAT_ATTR"): _KERNEL + " (csrc/megakernel.cu)",
    (f"{JAX_PKG}/ops/megakernel.py", "WS_ROWS"): _KERNEL + " (csrc/megakernel.cu)",
    (f"{JAX_PKG}/ops/megakernel.py", "F32"): "an alias of jnp.float32",
    (f"{JAX_PKG}/ops/megakernel.py", "U32"): "an alias of jnp.uint32",
    (f"{JAX_PKG}/ops/megakernel.py", "LIGHT_EMISSIVE"):
        "the kernel's copy of scene.prepare.LIGHT_EMISSIVE_TRI, which the port's "
        "scene/prepare.py keeps under that name",
    ("benchmarks/plucker_micro.py", "kern_mt"):
        "a Pallas kernel body: csrc/plucker.cu mt_kernel, behind keys_mt",
    ("benchmarks/plucker_micro.py", "make_kern_plk"):
        "a Pallas kernel body: csrc/plucker.cu highest_kernel and default_kernel, behind "
        "keys_plk",
    ("benchmarks/plucker_micro.py", "run"):
        "the pallas_call of those kernels; the port's main() times keys_mt / keys_plk",
    ("tools/showcase_renders.py", "OUT"):
        "the committed docs/renders/ folder the JAX tool writes into; the port writes only "
        "--out",
}

MOVED = {  # the megakernel's copies of shared constants, kept where they are defined
    (f"{JAX_PKG}/ops/megakernel.py", name): (f"{PORT_PKG}/scene/materials.py",
                                             "the material kinds")
    for name in ("INVISIBLE", "DIFFUSE", "DIELECTRIC", "CONDUCTOR", "EMISSIVE", "COATED_DIFFUSE")
}
MOVED.update({
    (f"{JAX_PKG}/ops/megakernel.py", name): (f"{PORT_PKG}/evaluation/integrators.py",
                                             "the sample streams' dimension layout")
    for name in ("CAMERA_DIMS", "DIM_BSDF", "DIM_LOBE", "DIM_LIGHT_PICK", "DIM_LIGHT_SAMPLE",
                 "DIM_RR", "BOUNCE_DIM_STRIDE")
})
MOVED.update({
    (f"{JAX_PKG}/ops/megakernel.py", name): (f"{PORT_PKG}/evaluation/bsdf.py",
                                             "the BSDF's constants")
    for name in ("INV_PI", "INV_TAU", "ALPHA_THRESHOLD")
})

_GEOM_NP = ("geom_np", "the geometry is packed from its numpy arrays before any upload")
_BINNED_KNOB = "a module constant of ops/binned_trace.py ({}): tests patch it"
RENAMED = {
    (f"{JAX_PKG}/ops/pallas_intersect.py", "build_prim_soa", "geom"): _GEOM_NP,
    (f"{JAX_PKG}/ops/pallas_intersect.py", "pack_sorted_prims", "geom"): _GEOM_NP,
    (f"{JAX_PKG}/ops/pallas_hier.py", "build_hier_soa", "geom"): _GEOM_NP,
    (f"{JAX_PKG}/ops/pallas_hier.py", "build_hier_soa_instanced", "geom"): _GEOM_NP,
    (f"{JAX_PKG}/aggregation/bvh.py", "trace_cost", "geom"):
        (None, "the traversal cost reads only the tree, which holds every box it tests"),
    (f"{JAX_PKG}/aggregation/bvh.py", "build_bvh", "host_out"):
        (None, "the port's SAH build returns numpy arrays; there is no device copy to avoid"),
    (f"{JAX_PKG}/processes/denoise.py", "init_params", "key"):
        ("generator", "a torch.Generator in place of a JAX PRNG key"),
    (f"{JAX_PKG}/processes/composition.py", "compose", "jit"):
        (None, "PyTorch runs the stack eagerly; there is nothing to jit"),
    (f"{JAX_PKG}/evaluation/scene_ops.py", "hit_light_record", "x"):
        (None, "unused by the JAX function's body"),
    (f"{JAX_PKG}/evaluation/wavefront.py", "sample_frame_wavefront", "sort_lanes"):
        (None, "the lane sort, off by default and measured a net loss on the TPU"),
    **{(f"{JAX_PKG}/evaluation/{mod}.py", fn, p): (None, NO_CALLER)
       for mod, fn in (("integrators", "path_step"), ("wavefront", "sample_frame_wavefront"),
                       ("scene_ops", "dispatch_summary"))
       for p in ("enable_nee", "enable_fwd_mis")},
    (f"{JAX_PKG}/utils/accumulator.py", "create", "dtype"): (None, NO_CALLER),
    **{(f"{JAX_PKG}/parallel/multihost.py", "initialize", p):
       (None, "JAX's coordinator arguments; the port takes torch.distributed's init_method, "
              "world_size and rank")
       for p in ("coordinator_address", "num_processes", "process_id", "local_device_ids")},
    **{(f"{JAX_PKG}/ops/binned_trace.py", fn, p): (None, _BINNED_KNOB.format(c))
       for fn in ("trace_binned", "occlude_binned")
       for p, c in (("rounds", "MAX_ROUNDS"), ("k", "K"), ("k_straggler", "K_STRAGGLER"))},
    **{(f"{JAX_PKG}/ops/binned_trace.py", fn, "**phase_kw"):
       (None, "the phase-shape knobs of the A/B engines (ROADMAP 'Not to port'); the port "
              "keeps the defaults as module constants")
       for fn in ("trace_binned", "occlude_binned")},
}

KEPT_PRIVATE = {
    f"{JAX_PKG}/aggregation/bvh.py": ("_slab_test", "_leaf_intersect", "_traverse",
                                      "_decode_leaf", "_encode_leaf"),
}

_UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _read(rel: str) -> dict:
    """A module's names: `public` (name -> parameter list, None for classes
    and constants), `functions` (every def and method, private ones too,
    with its parameters) and `present` (every name defined or imported at
    the top level, and every Class.method)."""
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    public, functions, present = {}, {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            present.add(node.name)
            functions[node.name] = _params(node)
            if not node.name.startswith("_"):
                public[node.name] = functions[node.name]
        elif isinstance(node, ast.ClassDef):
            present.add(node.name)
            if not node.name.startswith("_"):
                public[node.name] = None
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    key = f"{node.name}.{item.name}"
                    present.add(key)
                    functions[key] = _params(item)
                    if not node.name.startswith("_") and not item.name.startswith("_"):
                        public[key] = functions[key]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for leaf in ast.walk(target):
                    if isinstance(leaf, ast.Name):
                        present.add(leaf.id)
                        if _UPPER.match(leaf.id):
                            public[leaf.id] = None
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            present.update((a.asname or a.name).split(".")[0] for a in node.names)
    return dict(public=public, functions=functions, present=present)


def _cases() -> dict:
    pkg = sorted(p.relative_to(REPO).as_posix() for p in (REPO / JAX_PKG).rglob("*.py"))
    cases = {rel: PORT_PKG + rel[len(JAX_PKG):] for rel in pkg}
    cases.update(SCRIPTS)
    return cases


CASES = _cases()


def test_every_table_entry_names_a_case():
    keyed = {k[0] for k in (*NOT_PORTED, *MOVED, *RENAMED)} | set(KEPT_PRIVATE)
    assert keyed | set(NOT_PORTED_MODULES) <= set(CASES)
    for table in (NOT_PORTED, NOT_PORTED_MODULES):
        assert all(isinstance(r, str) and r.strip() for r in table.values())
    for table in (MOVED, RENAMED):
        assert all(isinstance(r, str) and r.strip() for _, r in table.values())
    assert len(CASES) > 60  # the package's modules were found


@pytest.mark.parametrize("jax_rel", list(CASES))
def test_port_has_every_public_name(jax_rel):
    port_rel = CASES[jax_rel]
    port_path = REPO / port_rel
    if jax_rel in NOT_PORTED_MODULES:
        assert not port_path.exists(), f"stale: {port_rel} exists; drop it from NOT_PORTED_MODULES"
        return
    assert port_path.exists(), f"{jax_rel} has no port at {port_rel}"
    jax_mod, port = _read(jax_rel), _read(port_rel)
    problems = []

    for (rel, name), reason in NOT_PORTED.items():
        if rel != jax_rel:
            continue
        if name not in jax_mod["public"]:
            problems.append(f"stale NOT_PORTED entry {name}: the JAX module has no such name")
        elif name in port["present"]:
            problems.append(f"stale NOT_PORTED entry {name}: the port has it now")
    for (rel, name), (target, reason) in MOVED.items():
        if rel != jax_rel:
            continue
        if name not in jax_mod["public"]:
            problems.append(f"stale MOVED entry {name}: the JAX module has no such name")
        if name in port["present"]:
            problems.append(f"stale MOVED entry {name}: {port_rel} has it")
        if name not in _read(target)["present"]:
            problems.append(f"{name} is not in {target}, where MOVED says it lives")
    for name in KEPT_PRIVATE.get(jax_rel, ()):
        if name not in jax_mod["functions"]:
            problems.append(f"stale KEPT_PRIVATE entry {name}")
        elif name not in port["functions"]:
            problems.append(f"private helper {name} missing from {port_rel}")

    for name, params in jax_mod["public"].items():
        if (jax_rel, name) in NOT_PORTED or (jax_rel, name) in MOVED:
            continue
        if name not in port["present"]:
            problems.append(f"missing: {name}")
            continue
        if params is None or name not in port["functions"]:
            continue
        have = {p.lstrip("*") for p in port["functions"][name]}
        for p in params:
            entry = RENAMED.get((jax_rel, name, p))
            if entry is None:
                if p.lstrip("*") not in have:
                    problems.append(f"{name} lacks parameter {p}")
            elif p.lstrip("*") in have:
                problems.append(f"stale RENAMED entry {name}({p}): the port has the parameter")
            elif entry[0] is not None and entry[0] not in have:
                problems.append(f"{name} lacks {entry[0]}, RENAMED's name for {p}")
    for (rel, name, p) in RENAMED:
        if rel == jax_rel and p not in (jax_mod["functions"].get(name) or ()):
            problems.append(f"stale RENAMED entry {name}({p}): the JAX function has no such "
                            f"parameter")
    assert not problems, f"{jax_rel} against {port_rel}:\n  " + "\n  ".join(problems)


@functools.cache
def _outside_tests() -> tuple:
    """(dotted module name, ast) of every script and module outside tests/
    that the port does not own: the JAX package, tools/, benchmarks/ and the
    top-level scripts."""
    files = [*(REPO / JAX_PKG).rglob("*.py"), *(REPO / "tools").glob("*.py"),
             *(REPO / "benchmarks").glob("*.py"), *REPO.glob("*.py")]
    out = []
    for path in sorted(files):
        parts = path.relative_to(REPO).with_suffix("").parts
        out.append((".".join(parts[:-1] if parts[-1] == "__init__" else parts),
                    path.name == "__init__.py", ast.parse(path.read_text(), filename=str(path))))
    return tuple(out)


def _refs(target: str, attr: str):
    """Each file's references to `attr` of module `target` (dotted): an
    import of the name from it, `alias.attr` for an alias of the module,
    and the bare name where it was imported and in the module itself.
    Yields (module, tree, node); for a call, node is the Call's func."""
    for mod, is_pkg, tree in _outside_tests():
        package = mod.split(".") if is_pkg else mod.split(".")[:-1]
        aliases, direct = set(), mod == target
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                base = package[:len(package) - node.level + 1] if node.level else []
                src = ".".join(base + ([node.module] if node.module else []))
                for a in node.names:
                    if src == target and a.name == attr:
                        direct = True
                        yield mod, tree, node
                    elif f"{src}.{a.name}" == target:
                        aliases.add(a.asname or a.name)
            elif isinstance(node, ast.Import):
                aliases.update(a.asname or a.name for a in node.names if a.name == target)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and node.attr == attr
                    and ast.unparse(node.value) in aliases):
                yield mod, tree, node
            elif direct and isinstance(node, ast.Name) and node.id == attr:
                yield mod, tree, node


def _defined_within(tree, names) -> set:
    """ids of every node inside a top-level definition of one of `names`."""
    inside = set()
    for node in tree.body:
        defined = ({node.name} if isinstance(node, (ast.FunctionDef, ast.ClassDef)) else
                   {t.id for t in getattr(node, "targets", ()) if isinstance(t, ast.Name)})
        if defined & set(names):
            inside.update(id(n) for n in ast.walk(node))
    return inside


def _dotted(rel: str) -> str:
    return rel[:-len(".py")].replace("/", ".")


TESTS_ONLY_ENTRIES = sorted(k for k, r in NOT_PORTED.items() if r == TESTS_ONLY)
NO_CALLER_ENTRIES = sorted(k for k, (_, r) in RENAMED.items() if r == NO_CALLER)


@pytest.mark.parametrize("rel,name", TESTS_ONLY_ENTRIES)
def test_tests_only_names_have_no_caller(rel, name):
    """A TESTS_ONLY name is referenced outside tests/ only in its own
    definition or in another TESTS_ONLY name's of the same module."""
    target = _dotted(rel)
    own = [n for r, n in TESTS_ONLY_ENTRIES if r == rel]
    users = []
    for mod, tree, node in _refs(target, name):
        if mod == target and id(node) in _defined_within(tree, own):
            continue
        users.append(f"{mod}:{node.lineno}")
    assert not users, f"{name} of {rel} is used outside the tests: {users}"


@pytest.mark.parametrize("rel,fn,param", NO_CALLER_ENTRIES)
def test_no_caller_parameters_are_set_by_no_caller(rel, fn, param):
    """No call of a NO_CALLER parameter's function outside tests/ passes it,
    but as the same name handed on, nor reaches it by position or by a
    ** splat."""
    jax_fn = ast.parse((REPO / rel).read_text())
    args = next(n.args for n in jax_fn.body
                if isinstance(n, ast.FunctionDef) and n.name == fn)
    positional = [a.arg for a in args.posonlyargs + args.args]
    setters = []
    for mod, tree, node in _refs(_dotted(rel), fn):
        for call in ast.walk(tree):
            if not (isinstance(call, ast.Call) and call.func is node):
                continue
            sets = any(k.arg is None or (k.arg == param and not (
                isinstance(k.value, ast.Name) and k.value.id == param)) for k in call.keywords)
            if param in positional:
                sets |= len(call.args) > positional.index(param)
                sets |= any(isinstance(a, ast.Starred) for a in call.args)
            if sets:
                setters.append(f"{mod}:{call.lineno}")
    assert not setters, f"{fn}({param}) of {rel} is set by {setters}"
