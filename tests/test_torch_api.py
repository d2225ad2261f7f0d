"""The port does all that the JAX package does: every public name of
bflow_tpu/ (outside ops/pallas/, whose counterparts are csrc/ and
kernels/) has a same-named counterpart in the same-named module of
bflow_tpu_torch/, with every public argument, or an entry in EXEMPT below
that names its torch counterpart or its reason.

Both packages are read as text and parsed with ast; nothing of either is
imported. Per JAX module, one case. A module's public API is:
  * each module-level function and class whose name has no leading
    underscore, and the names of its ``__all__``;
  * each class's public methods and properties, and its ``__call__``
    (the port's ``forward`` counts for it);
  * the arguments of each: a function's or method's parameters without a
    leading underscore (``self``, ``cls``, ``*args`` and ``**kwargs``
    aside), a class's constructor parameters (its ``__init__``'s, or its
    annotated fields: flax modules and dataclasses).

EXEMPT keys a gap as "module", "module:Name", "module:Name.method" or
"module:Name(arg)"; its value is (the port's counterpart in the same
notation, or None; the reason). A case fails on a gap without an entry,
on an entry whose gap is gone (the table stays exact), and on a
counterpart the port does not have.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "bflow_tpu", ROOT / "bflow_tpu_torch"

CV2 = "matplotlib figure -> the cv2 renderer of the same panel (the card's " \
      "machine has no matplotlib)"
TRAIN = "flax's train= argument -> nn.Module.train() / .eval()"
DTYPE = "a flax module's computation dtype -> compute_dtype (a torch " \
        "module's dtype is its parameters')"
KERNEL = "the Pallas switch -> the CUDA kernel switch"
EXEMPT: Dict[str, Tuple[Optional[str], str]] = {
    # callbacks
    "callbacks/visualization.py:bezier_trajectory_figure": (
        "callbacks/visualization.py:bezier_trajectory_image", CV2),
    "callbacks/visualization.py:grad_flow_figure": (
        "callbacks/visualization.py:grad_flow_image", CV2),
    "callbacks/visualization.py:figure_to_array": (
        None, "rasterizes a matplotlib figure; the cv2 renderers draw "
              "arrays directly"),
    # data
    "data/grain_loader.py:make_grain_loader": (
        "data/grain_loader.py:ProcessLoader",
        "Grain's loader -> DataLoader worker processes with the threaded "
        "Loader's batches"),
    # importer
    "importer/torch_ckpt.py": (
        "train/checkpoint.py:port_state_dict",
        "maps a reference .ckpt onto flax variables; the port's modules "
        "carry the reference's names, so it maps the state dict itself"),
    # loggers
    "loggers/wandb_logger.py:WandbLogger.log_histograms(tree)": (
        "loggers/wandb_logger.py:WandbLogger.log_histograms(model)",
        "a parameter pytree -> the module's named_parameters()"),
    "loggers/wandb_logger.py:WandbLogger.upload_checkpoint(ckpt_dir)": (
        "loggers/wandb_logger.py:WandbLogger.upload_checkpoint(ckpt_path)",
        "an orbax directory -> a torch.save file (or a directory)"),
    # models
    "models/corr.py:resolve_lookup_method": (
        "models/corr.py:corr_lookup",
        "'auto' picks the TPU path from JAX's backend; in the port it is "
        "the lookup kernel, whose wrapper dispatches on the tensor's "
        "device"),
    "models/extractor.py:conv_precision": (
        "utils/precision.py:full_f32",
        "Precision.HIGHEST per conv -> TF32 off for the forward's span"),
    "models/extractor.py:instance_norm": (
        "models/extractor.py:InstanceNorm", "a function -> an nn.Module"),
    "models/extractor.py:Norm": (
        "models/extractor.py:make_norm",
        "one flax module switching on its kind -> a factory of the group, "
        "batch and instance norm modules"),
    "models/extractor.py:dot_1x1": (
        "models/extractor.py:Conv1x1",
        "XLA's rewrite of a 1x1 conv as one matmul for the TPU's MXU; on "
        "the card cuDNN runs the conv"),
    "models/extractor.py:dot_im2col": (
        "models/extractor.py:conv2d",
        "XLA's im2col rewrite for the MXU; on the card cuDNN or the conv "
        "kernels run the conv"),
    "models/extractor.py:Conv3x3": (
        "models/extractor.py:Conv2d",
        "a flax conv with the Pallas switch -> nn.Conv2d with use_kernel"),
    "models/extractor.py:StemConv": (
        "models/extractor.py:Conv2d",
        "the 7x7 stride-2 stem is a Conv2d; its space-to-depth rewrite "
        "was measured slower and no config sets it"),
    "models/extractor.py:Conv1x1(features)": (
        "models/extractor.py:Conv1x1(cout)", "nn.Conv2d's naming"),
    "models/extractor.py:Conv1x1(dtype)": (
        "models/extractor.py:Conv1x1(compute_dtype)", DTYPE),
    "models/extractor.py:ResidualBlock(dtype)": (
        "models/extractor.py:ResidualBlock(compute_dtype)", DTYPE),
    "models/extractor.py:ResidualBlock(conv_pallas)": (
        "models/extractor.py:ResidualBlock(conv_kernel)", KERNEL),
    "models/extractor.py:ResidualBlock.__call__(train)": (None, TRAIN),
    "models/extractor.py:BasicEncoder(dtype)": (
        "models/extractor.py:BasicEncoder(compute_dtype)", DTYPE),
    "models/extractor.py:BasicEncoder(stem_s2d)": (
        None, "the stem's space-to-depth rewrite, measured slower; no "
              "config sets it"),
    "models/extractor.py:BasicEncoder(stem_pallas)": (
        "models/extractor.py:BasicEncoder(stem_kernel)", KERNEL),
    "models/extractor.py:BasicEncoder(conv_pallas)": (
        "models/extractor.py:BasicEncoder(conv_kernel)", KERNEL),
    "models/extractor.py:BasicEncoder.__call__(train)": (None, TRAIN),
    "models/raft_spline.py:RAFTSpline.setup": (
        "models/raft_spline.py:RAFTSpline",
        "flax's setup -> nn.Module.__init__"),
    "models/raft_spline.py:RAFTSpline.__call__(train)": (None, TRAIN),
    "models/update.py:Conv2dParams": (
        "models/update.py:SepConvGRU",
        "bare conv parameters for the fused GRU gates -> the per-gate "
        "Conv2d modules, whose weights SepConvGRU fuses"),
    "models/update.py:BezierHead(dtype)": (
        "models/update.py:BezierHead(compute_dtype)", DTYPE),
    "models/update.py:BezierHead(use_pallas)": (
        "models/update.py:BezierHead(use_kernel)", KERNEL),
    "models/update.py:SepConvGRU(dtype)": (
        "models/update.py:SepConvGRU(compute_dtype)", DTYPE),
    "models/update.py:SepConvGRU(fused)": (
        "models/update.py:SepConvGRU(use_kernel)",
        "the fused gate form, fewer and wider launches for the MXU, is "
        "taken with the conv kernels; cuDNN runs the per-gate form"),
    "models/update.py:SepConvGRU(use_pallas)": (
        "models/update.py:SepConvGRU(use_kernel)", KERNEL),
    "models/update.py:BasicMotionEncoder(config)": (
        "models/update.py:BasicMotionEncoder(cfg)", "renamed"),
    "models/update.py:BasicUpdateBlock(config)": (
        "models/update.py:BasicUpdateBlock(cfg)", "renamed"),
    # ops
    "ops/bezier.py:BezierCurves.tree_flatten": (
        None, "JAX pytree registration; torch needs none"),
    "ops/bezier.py:BezierCurves.tree_unflatten": (
        None, "JAX pytree registration; torch needs none"),
    "ops/bezier.py:BezierCurves.stop_gradient": (
        None, "jax.lax.stop_gradient -> BezierCurves(params.detach())"),
    # parallel
    "parallel/__init__.py:make_mesh": (
        "parallel/distributed.py:initialize_distributed",
        "a device mesh -> a process group, one rank per card"),
    "parallel/__init__.py:batch_sharding": (
        "parallel/mesh.py:shard_batch",
        "a NamedSharding -> each rank's slice of the batch"),
    "parallel/distributed.py:initialize_distributed(coordinator_address)": (
        "parallel/distributed.py:initialize_distributed(init_method)",
        "jax.distributed's names -> torch.distributed's"),
    "parallel/distributed.py:initialize_distributed(num_processes)": (
        "parallel/distributed.py:initialize_distributed(world_size)",
        "jax.distributed's names -> torch.distributed's"),
    "parallel/distributed.py:initialize_distributed(process_id)": (
        "parallel/distributed.py:initialize_distributed(rank)",
        "jax.distributed's names -> torch.distributed's"),
    "parallel/mesh.py:make_mesh": (
        "parallel/distributed.py:initialize_distributed",
        "a device mesh -> a process group, one rank per card"),
    "parallel/mesh.py:batch_sharding": (
        "parallel/mesh.py:shard_batch",
        "a NamedSharding -> each rank's slice of the batch"),
    "parallel/mesh.py:replicate(mesh)": (
        None, "the process group is the mesh"),
    "parallel/mesh.py:shard_batch(mesh)": (
        None, "the process group is the mesh"),
    # train
    "train/checkpoint.py:CheckpointManager.restore(template)": (
        "train/checkpoint.py:CheckpointManager.restore(state)",
        "restores into the state's module and optimizer in place"),
    "train/checkpoint.py:CheckpointManager.close": (
        None, "waits for orbax's asynchronous writes; torch.save has "
              "written when it returns"),
    "train/checkpoint.py:restore_weights_only(template_variables)": (
        "train/checkpoint.py:restore_weights_only(model)",
        "loads into the module in place"),
    "train/state.py:TrainState(params)": (
        "train/state.py:TrainState(model)",
        "the module holds its parameters and BatchNorm statistics"),
    "train/state.py:TrainState(batch_stats)": (
        "train/state.py:TrainState(model)",
        "the module holds its parameters and BatchNorm statistics"),
    "train/state.py:TrainState(opt_state)": (
        "train/state.py:TrainState(optimizer)",
        "the optimizer holds its state"),
    "train/state.py:TrainState.create(tx)": (
        "train/state.py:TrainState.create(training_cfg)",
        "an optax chain -> the optimizer and scheduler built from the "
        "training config"),
    "train/state.py:TrainState.variables": (
        None, "flax variables -> model.state_dict()"),
    "train/step.py:grad_norm_tree(grads)": (
        "train/step.py:grad_norm_tree(model)",
        "a gradient pytree -> the parameters' .grad"),
    "train/step.py:make_train_step(tx)": (
        "train/step.py:make_train_step(optimizer)",
        "an optax chain -> a torch optimizer and scheduler"),
    "train/step.py:init_metric_acc(metrics_template)": (
        "train/step.py:init_metric_acc(keys)",
        "a metrics pytree -> its keys"),
    # utils
    "utils/timers.py:DeviceTimer(outputs_getter)": (
        None, "block_until_ready on the block's outputs -> a CUDA event "
              "pair, read at the summary"),
}


def _args(fn: ast.FunctionDef) -> List[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls") and not x.arg.startswith("_")]


def api(path: Path) -> Dict[str, Optional[List[str]]]:
    """name -> its public arguments (None: bound by an import or an
    assignment, arguments unknown)."""
    out: Dict[str, Optional[List[str]]] = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _args(node)
        elif isinstance(node, ast.ClassDef):
            init = [s for s in node.body if isinstance(s, ast.FunctionDef)
                    and s.name == "__init__"]
            out[node.name] = (_args(init[0]) if init else [
                s.target.id for s in node.body
                if isinstance(s, ast.AnnAssign)
                and isinstance(s.target, ast.Name)
                and not s.target.id.startswith("_")])
            for sub in node.body:
                if not isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    continue
                name = "__call__" if sub.name == "forward" else sub.name
                if not name.startswith("_") or name == "__call__":
                    out.setdefault(f"{node.name}.{name}", _args(sub))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.setdefault((alias.asname or alias.name).split(".")[0],
                               None)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, None)
    return out


def exports(path: Path) -> List[str]:
    """The names of a module's __all__."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)):
            return list(ast.literal_eval(node.value))
    return []


def gaps(rel: str) -> List[str]:
    """The JAX module's public names and arguments the port's same-named
    module lacks."""
    port = PORT / rel
    if not port.exists():
        return [rel]
    want, have = api(JAX / rel), api(port)
    public = [n for n in want if n.split(".")[-1] == "__call__"
              or not n.split(".")[-1].startswith("_")]
    out = [f"{rel}:{n}" for n in exports(JAX / rel) if n not in have]
    for name in public:
        args = want[name]
        if args is None or name in exports(JAX / rel):
            continue
        if name.split(".")[0] not in have:
            if "." not in name:  # a missing class: its members go with it
                out.append(f"{rel}:{name}")
            continue
        if name not in have:
            out.append(f"{rel}:{name}")
            continue
        out += [f"{rel}:{name}({a})" for a in args
                if a not in (have[name] or [])]
    return out


def resolves(ref: str) -> bool:
    """Whether the port has the counterpart ref names."""
    rel, _, name = ref.partition(":")
    if not (PORT / rel).exists():
        return False
    have = api(PORT / rel)
    name, _, arg = name.partition("(")
    if name not in have:
        return False
    return not arg or arg.rstrip(")") in (have[name] or [])


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                 if p.relative_to(JAX).parts[:2] != ("ops", "pallas"))


def test_modules_found():
    assert len(MODULES) > 40 and "models/raft_spline.py" in MODULES
    assert all(k.split(":")[0] in MODULES for k in EXEMPT), \
        "an exemption names a module the JAX package does not have"


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_the_public_api(rel):
    found = sorted(gaps(rel))
    listed = sorted(k for k in EXEMPT if k.split(":")[0] == rel)
    missing = [g for g in found if g not in EXEMPT]
    assert not missing, f"the port lacks {missing}: port them, or add an " \
                        f"entry to EXEMPT with the counterpart or reason"
    stale = [k for k in listed if k not in found]
    assert not stale, f"EXEMPT lists {stale}, which the port now has"
    for key in listed:
        counterpart, reason = EXEMPT[key]
        assert reason, key
        assert counterpart is None or resolves(counterpart), \
            f"{key}: the port has no {counterpart}"
