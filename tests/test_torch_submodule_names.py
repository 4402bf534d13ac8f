"""Every ported submodule's public names and signatures against the JAX
package's (``tests/test_torch_toplevel_names.py`` does the top level).

The public surface of a JAX submodule: its ``__all__`` when it has one,
else, for a package, what its ``__init__`` defines or re-exports (an
import marked ``# noqa: F401``). Each such name must exist on the port's
module of the same dotted path, and each callable both modules have must
take the JAX parameters: the same names, in the same order, with the same
defaults (the port may add parameters of its own with defaults, such as
``device``). The exceptions are listed below with their reasons: the
modules and names of later ROADMAP items (section 1), the TPU library,
and signatures that differ by design (a JAX ``key``, mesh ``axis`` or
``devices`` where the port takes a ``torch.Generator`` or a process
group).

Tolerance: exact.
"""
import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

#: submodules whose names wait for a later ROADMAP item
NOT_PORTED_MODULES = {
    "paddle_tpu.analysis": "item 6 (analysis): only findings and "
                           "mpmd_lint are ported",
    "paddle_tpu.csrc": "the TPU native library (no port counterpart)",
}

#: (module, name) -> why the port does not have it (yet)
NOT_PORTED_NAMES = {
    **{("paddle_tpu.distributed", n): "item 2 (auto_parallel, checkpoint)"
       for n in ("DistModel", "Partial", "Placement", "ProcessMesh",
                 "Replicate", "Shard", "ShardingStage1", "ShardingStage2",
                 "ShardingStage3", "dtensor_from_fn", "parallelize",
                 "reshard", "shard_dataloader", "shard_layer",
                 "shard_optimizer", "shard_tensor", "to_static",
                 "unshard_dtensor", "Strategy", "load_state_dict",
                 "save_state_dict", "DistAttr", "ReduceType",
                 "shard_scaler")},
    **{("paddle_tpu.distributed", n): "item 5 (distributed/compat.py)"
       for n in ("CountFilterEntry", "InMemoryDataset", "ParallelMode",
                 "ProbabilityEntry", "QueueDataset", "ShowClickEntry",
                 "gather", "gloo_barrier", "gloo_init_parallel_env",
                 "gloo_release", "scatter_object_list", "split")},
    **{("paddle_tpu.distributed.fleet", n): "item 5 (fleet/compat.py, "
       "parameter servers)"
       for n in ("Fleet", "MultiSlotDataGenerator",
                 "MultiSlotStringDataGenerator", "UtilBase", "init_server",
                 "run_server", "init_worker", "stop_worker")},
    ("paddle_tpu.distributed.communication", "p2p_shift"):
        "a shard_map ppermute; waits for the item that needs it",
    ("paddle_tpu.inference", "convert_to_mixed_precision"):
        "not ported: no caller (ROADMAP, divergences by design: the high-level paths)",
}

#: (module, name) -> why the signature differs by design
SIGNATURE_BY_DESIGN = {
    **{(m, "Group"): "a torch.distributed process group, not a mesh axis"
       for m in ("paddle_tpu.distributed",
                 "paddle_tpu.distributed.communication")},
    **{(m, "new_group"): "ranks make a process group; no mesh axis_name"
       for m in ("paddle_tpu.distributed",
                 "paddle_tpu.distributed.communication")},
    **{(m, "get_group"): "Paddle's id keyword (JAX's gid is ignored "
       "there); the port is the more lenient side"
       for m in ("paddle_tpu.distributed",
                 "paddle_tpu.distributed.communication")},
    ("paddle_tpu.distributed", "build_mesh"):
        "the port's mesh is of ranks, not of jax devices",
    ("paddle_tpu.distributed", "init_parallel_env"):
        "torch.distributed takes its rendezvous, not "
        "jax.distributed.initialize's arguments",
    ("paddle_tpu.distributed.mpmd_runtime", "PipelinePrograms"):
        "the stage programs are torch modules' events, not jitted "
        "functions",
    ("paddle_tpu.framework", "ParamAttr"):
        "the JAX package has two ParamAttr classes, framework's "
        "(do_model_average=False) and nn's (True, Paddle's default); the "
        "port has one, nn's",
    **{(m, "seed"): "the port's seed defaults its argument (the more "
       "lenient side)" for m in ("paddle_tpu", "paddle_tpu.framework")},
    ("paddle_tpu.incubate.distributed.models.moe", "GroupedExpertsFFN"):
        "experts shard over the ep process group, not a mesh ep_axis",
    ("paddle_tpu.incubate.distributed.models.moe", "topk_gating"):
        "jitter draws from a torch.Generator, not a JAX key",
    ("paddle_tpu.jit", "TranslatedLayer"):
        "a torch.export program, not a JAX exported function",
    ("paddle_tpu.quantization", "kv_dequantize_arrays"):
        "the default dtype is torch.float32 for jnp.float32",
    ("paddle_tpu.sparse", "SparseTensor"):
        "COO indices and values, not a jax BCOO",
}


def _public_names(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    if not hasattr(mod, "__path__"):
        return []
    src = inspect.getsource(mod)
    lines = src.splitlines()
    out = []
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, ast.Assign):
            out += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.ImportFrom):
            seg = "\n".join(lines[node.lineno - 1:node.end_lineno])
            if "noqa: F401" in seg:
                out += [a.asname or a.name for a in node.names
                        if a.name != "*"]
    return [n for n in out if not n.startswith("_")]


def _pairs():
    """(JAX module, port module) for every JAX module file with a port
    file at the same path, found on disk (nothing imported at
    collection)."""
    jroot = ROOT / "paddle_tpu"
    out = []
    for path in sorted(jroot.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        name = ".".join(parts)
        if any(name == m or name.startswith(m + ".")
               for m in NOT_PORTED_MODULES):
            continue
        tparts = ["paddle_tpu_torch"] + parts[1:]
        tdir = ROOT.joinpath(*tparts)
        if not ((tdir / "__init__.py").exists()
                or tdir.with_suffix(".py").exists()):
            continue
        out.append((name, ".".join(tparts)))
    return out


PAIRS = _pairs()


def _params(fn):
    var = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    sig = inspect.signature(fn)
    return ([p for p in sig.parameters.values() if p.kind not in var],
            any(p.kind == inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values()))


def _same_default(a, b):
    try:
        return a is b or bool(a == b)
    except Exception:  # noqa: BLE001 — an array-valued default
        return False


def _signature_gaps(jfn, tfn):
    try:
        jps, _ = _params(jfn)
        tps, t_varkw = _params(tfn)
    except (TypeError, ValueError):
        return []
    tmap = {p.name: p for p in tps}
    gaps = []
    for p in jps:
        q = tmap.get(p.name)
        if q is None:
            if not t_varkw:
                gaps.append(f"no parameter {p.name!r}")
        elif not _same_default(p.default, q.default):
            gaps.append(f"{p.name}: default {q.default!r}, JAX {p.default!r}")
    jn = [p.name for p in jps if p.name in tmap]
    if jn != [p.name for p in tps if p.name in set(jn)]:
        gaps.append(f"order {[p.name for p in tps]}, JAX {jn}")
    jset = {p.name for p in jps}
    gaps += [f"required extra parameter {p.name!r}" for p in tps
             if p.name not in jset and p.default is inspect.Parameter.empty]
    return gaps


def test_the_walk_covers_the_ported_submodules():
    names = {j for j, _ in PAIRS}
    assert len(PAIRS) > 100
    for mod in ("paddle_tpu.framework", "paddle_tpu.text.models",
                "paddle_tpu.distributed.launch", "paddle_tpu.core",
                "paddle_tpu.inference", "paddle_tpu.incubate.nn.functional",
                "paddle_tpu.distributed.fleet"):
        assert mod in names, mod


def _import(name):
    """``importlib.import_module(name)``, leaving the parent package's
    attribute of that name as it was: a package may rebind a submodule's
    name to a function (``text.viterbi_decode``), and importing the
    submodule again must not undo that for the tests that share the
    process."""
    parent, _, leaf = name.rpartition(".")
    pkg = importlib.import_module(parent) if parent else None
    before = getattr(pkg, leaf, None)
    mod = importlib.import_module(name)
    if before is not None and getattr(pkg, leaf, None) is not before:
        setattr(pkg, leaf, before)
    return mod


@pytest.mark.parametrize("jname,tname", PAIRS, ids=[j for j, _ in PAIRS])
def test_public_names_and_signatures_match_jax(jname, tname):
    jmod = _import(jname)
    tmod = _import(tname)
    missing, gaps = [], {}
    for n in _public_names(jmod):
        obj = getattr(jmod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if (jname, n) in NOT_PORTED_NAMES:
            continue
        if not hasattr(tmod, n):
            missing.append(n)
            continue
        tobj = getattr(tmod, n)
        if callable(obj) and callable(tobj) \
                and (jname, n) not in SIGNATURE_BY_DESIGN:
            g = _signature_gaps(obj, tobj)
            if g:
                gaps[n] = g
    assert not missing, f"{tname} lacks {missing}"
    assert not gaps, f"{tname}: signatures differ from JAX's: {gaps}"


def test_every_exception_is_still_needed():
    """An exception for a name the port now has, with the JAX signature,
    must go: the lists only hold real gaps."""
    for (jname, n), why in NOT_PORTED_NAMES.items():
        port = "paddle_tpu_torch" + jname[len("paddle_tpu"):]
        assert not hasattr(_import(port), n), (jname, n, why)
    for (jname, n), why in SIGNATURE_BY_DESIGN.items():
        port = "paddle_tpu_torch" + jname[len("paddle_tpu"):]
        jfn = getattr(_import(jname), n)
        tfn = getattr(_import(port), n)
        assert _signature_gaps(jfn, tfn), (jname, n, why)
