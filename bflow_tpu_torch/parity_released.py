"""One-command parity tool for the released reference checkpoints
(counterpart of scripts/parity_released.py), on the GPU unless the caller
asks for the CPU:

    python -m bflow_tpu_torch.parity_released <ckpt.ckpt> [dataset.path=DIR]
        [--iters 12] [--times 0.5,1.0] [--size H W] [--skip-torch]
        [--bf16-also] [--q8-also] [--device cpu]
    python -m bflow_tpu_torch.parity_released --all   # 4-family table

Given a PyTorch Lightning checkpoint of the reference (uzh-rpg/bflow; its
README lists the four released files), this:

  1. infers the experiment architecture from the state dict (context /
     correlation bins, Bezier degree, boundary images);
  2. where the reference tree is present (importer/reference_oracle.py),
     loads the SAME weights into the actual reference network and into
     the port in f32, runs identical random inputs, and prints max/mean
     flow deltas at the requested query times; where it is absent, says
     that the oracle was skipped;
  3. with --bf16-also, repeats the port's forward in bf16 against the f32
     one; with --q8-also, also the int8 volume mode (lookup_method
     'pallas_q8', inference only) against bf16;
  4. if `dataset.path=...` is given, runs the f32 validation
     (bflow_tpu_torch.val) on the real dataset with the family's
     experiment overlay and prints its metrics.

Its f32 mode and the oracle's forward run at full f32 on the GPU
(utils/precision.py:full_f32: TF32 off inside each call, the caller's
flags given back after it).

--all builds a random-init stand-in for each released family: the port's
seeded model exported in the reference layout (random_init_state_dict),
weights damped so that 12 iterations stay finite.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bflow_tpu_torch.models import RaftSplineConfig
from bflow_tpu_torch.utils.precision import full_f32


def infer_config(sd: dict):
    """Experiment architecture from state-dict shapes.

    nbins_correlation = fnet_ev.conv1 in-channels; nbins_context =
    cnet.conv1 in-channels (-3 with images); bezier degree = bezier
    head out-channels / 2; images = fnet_img present. Target indices /
    pyramid levels are not recoverable from shapes: they follow the
    released experiment matrix (reference config/experiment/**)."""
    use_images = any(k.startswith("net.fnet_img.") for k in sd)
    nbins_corr = sd["net.fnet_ev.conv1.weight"].shape[1]
    nbins_ctx = sd["net.cnet.conv1.weight"].shape[1] - (
        3 if use_images else 0
    )
    degree = sd["net.update_block.bezier_head.conv2.weight"].shape[0] // 2
    if degree <= 2:  # DSEC family: E[_I]_LU4_BD2
        targets, levels = (1, 2, 3, 4), (1, 1, 1, 4)
    else:  # MultiFlow family: E[_I]_LU5_BD10
        targets, levels = (8, 16, 24, 32, 40), (1, 1, 1, 1, 4)
    assert max(targets) < nbins_ctx + nbins_corr, (targets, nbins_ctx)
    name = (
        f"{'E_I' if use_images else 'E'}_LU{len(levels)}_BD{degree}"
        f" (ctx={nbins_ctx}, corr={nbins_corr})"
    )
    cfg = RaftSplineConfig(
        nbins_context=nbins_ctx,
        nbins_correlation=nbins_corr,
        bezier_degree=degree,
        ev_target_indices=targets,
        ev_levels=levels,
        use_events=True,
        use_images=use_images,
    )
    return cfg, name


def load_state_dict(path: str) -> dict:
    """The ``net.*`` entries of a Lightning checkpoint (or a bare state
    dict) as the file holds them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if k.startswith("net.")}


def load_model(cfg, sd, precision, lookup_method=None, device="cuda"):
    """The port's model from a ``net.*`` state dict, loaded strictly, at
    ``precision`` (correlation and compute) and ``lookup_method``, on
    ``device``."""
    from bflow_tpu_torch import build_model
    from bflow_tpu_torch.train.checkpoint import port_state_dict

    cfg = dataclasses.replace(
        cfg, corr_precision=precision, compute_dtype=precision,
        **({"lookup_method": lookup_method} if lookup_method else {}),
    )
    model = build_model(cfg, device=device)
    model.load_state_dict(port_state_dict(
        {k: torch.as_tensor(v) for k, v in sd.items()},
        model.state_dict()))
    return model


def model_inputs(model, voxel_nchw, images_nchw):
    """The tool's NCHW numpy inputs as the model's channels-last tensors
    on its device: (voxel, images or None)."""
    dev = next(model.parameters()).device
    voxel = torch.from_numpy(voxel_nchw.transpose(0, 2, 3, 1)).to(dev)
    images = None
    if model.config.use_images:
        images = torch.from_numpy(
            np.stack(images_nchw).transpose(0, 1, 3, 4, 2)).to(dev)
    return voxel, images


def model_flow(model, voxel_nchw, images_nchw, iters,
               times) -> Dict[float, np.ndarray]:
    """{t: flow (N, 2, H, W) numpy} of ``model`` on the tool's inputs."""
    voxel, images = model_inputs(model, voxel_nchw, images_nchw)
    _, up = model(voxel, images, iters=iters, test_mode=True)
    return {
        t: up.flow_at(float(t)).permute(0, 3, 1, 2).float().cpu().numpy()
        for t in times
    }


def our_flow(cfg, sd, voxel_nchw, images_nchw, iters, times, precision,
             lookup_method=None, device="cuda") -> Dict[float, np.ndarray]:
    """The port's forward from a ``net.*`` state dict, loaded strictly, at
    ``precision`` and ``lookup_method``, on ``device``:
    {t: flow (N, 2, H, W) numpy}."""
    model = load_model(cfg, sd, precision, lookup_method, device)
    return model_flow(model, voxel_nchw, images_nchw, iters, times)


def report(tag, got, want) -> float:
    """Print the deltas per query time; returns the max relative one."""
    rel = 0.0
    for t in sorted(got):
        d = np.abs(got[t] - want[t])
        mag = max(np.abs(want[t]).max(), 1e-8)
        rel = max(rel, float(d.max() / mag))
        print(
            f"  [{tag}] flow@t={t}: max|d|={d.max():.3e} "
            f"mean|d|={d.mean():.3e} rel={d.max() / mag:.3e} "
            f"(EPE-style mean={np.linalg.norm(got[t] - want[t], axis=1).mean():.4e})"
        )
    return rel


# The four released checkpoint families (reference README.md:67-95 and
# config/experiment/{dsec,multiflow}/raft_spline/*.yaml). Used by --all
# to build random-init stand-ins.
RELEASED_FAMILIES = (
    ("E_LU4_BD2", dict(nbins_context=15, nbins_correlation=15,
                       bezier_degree=2, ev_target_indices=(1, 2, 3, 4),
                       ev_levels=(1, 1, 1, 4), use_events=True,
                       use_images=False)),
    ("E_I_LU4_BD2", dict(nbins_context=15, nbins_correlation=15,
                         bezier_degree=2, ev_target_indices=(1, 2, 3, 4),
                         ev_levels=(1, 1, 1, 4), use_events=True,
                         use_images=True)),
    ("E_LU5_BD10", dict(nbins_context=41, nbins_correlation=25,
                        bezier_degree=10,
                        ev_target_indices=(8, 16, 24, 32, 40),
                        ev_levels=(1, 1, 1, 1, 4), use_events=True,
                        use_images=False)),
    ("E_I_LU5_BD10", dict(nbins_context=41, nbins_correlation=25,
                          bezier_degree=10,
                          ev_target_indices=(8, 16, 24, 32, 40),
                          ev_levels=(1, 1, 1, 1, 4), use_events=True,
                          use_images=True)),
)


def random_init_state_dict(cfg, seed: int) -> Dict[str, torch.Tensor]:
    """A random-init stand-in for a released ``.ckpt``'s state dict: the
    port's seeded model (build_model) exported in the reference layout:
    ``net.*`` keys, OIHW conv weights, each downsample norm also under its
    ``norm3`` alias, BatchNorm statistics kept, ``num_batches_tracked``
    left out. Float tensors of two or more dimensions (the conv weights)
    are damped 20x, as the JAX tool damps its reference export: an
    untrained network's 12-iteration recurrence blows up at its native
    init scale."""
    from bflow_tpu_torch import build_model

    model = build_model(cfg, device="cpu", seed=seed)
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.detach().clone()
        if v.ndim >= 2 and v.is_floating_point():
            v = v * 0.05
        out["net." + k] = v
        if ".downsample.1." in k:
            out["net." + k.replace(".downsample.1.", ".norm3.")] = v
    return out


def random_inputs(cfg, size, seed: int = 3):
    """The tool's random inputs: a (1, nbins_total, H, W) voxel grid and
    two (1, 3, H, W) frames, drawn with numpy."""
    H, W = size
    rng = np.random.default_rng(seed)
    voxel = rng.standard_normal((1, cfg.nbins_total, H, W)).astype(
        np.float32
    )
    images = [
        rng.integers(0, 255, (1, 3, H, W)).astype(np.float32)
        for _ in range(2)
    ]
    return voxel, images


def run_family(name: str, sd: dict, cfg, iters: int, times, size,
               device="cuda") -> Optional[float]:
    """One side-by-side row: the port in f32 vs the reference oracle on
    identical random inputs. Returns the max relative flow delta, or None
    where the reference tree is absent."""
    from bflow_tpu_torch.importer.reference_oracle import (
        reference_available,
        torch_forward_flow,
    )

    voxel, images = random_inputs(cfg, size)
    ours = our_flow(sd=sd, cfg=cfg, voxel_nchw=voxel, images_nchw=images,
                    iters=iters, times=times, precision="float32",
                    device=device)
    if not reference_available():
        print(f"  [{name}] torch oracle skipped (reference tree "
              f"unavailable); the port's f32 flow is finite: "
              f"{all(np.isfinite(f).all() for f in ours.values())}")
        return None
    with full_f32():
        want = torch_forward_flow(cfg, sd, voxel, images, iters=iters,
                                  times=times)
    return report(name, ours, want)


def run_all(args) -> List[tuple]:
    """--all: the 4-family parity table. Each family's random-init export
    runs through the port in f32 at the released iteration count, against
    the actual reference network where its tree is present."""
    times = tuple(float(t) for t in args.times.split(","))
    rows = []
    for seed, (name, kw) in enumerate(RELEASED_FAMILIES):
        cfg = RaftSplineConfig(**kw)
        sd = random_init_state_dict(cfg, seed)
        rel = run_family(name, sd, cfg, args.iters, times, args.size,
                         args.device)
        rows.append((name, rel))
    print()
    print(f"{'family':16s} {'max rel flow delta':>20s}  verdict "
          f"({args.iters} iters, f32)")
    ok = True
    for name, rel in rows:
        if rel is None:
            print(f"{name:16s} {'-':>20s}  oracle skipped")
            continue
        verdict = "PASS" if rel <= 1e-3 else "FAIL"
        ok &= rel <= 1e-3
        print(f"{name:16s} {rel:20.3e}  {verdict}")
    print("(random-init exports in the reference layout; rerun with the "
          "released files + dataset.path=... for the real EPE table)")
    if not ok:
        sys.exit(1)
    return rows


def val_argv(cfg, ckpt: str, overrides) -> List[str]:
    """The validation's overrides for a checkpoint of this architecture:
    its dataset and experiment overlay, the checkpoint, f32 precision,
    then the caller's ``key=value`` overrides."""
    exp = (
        "+experiment/dsec/raft_spline="
        f"{'E_I' if cfg.use_images else 'E'}_LU4_BD2_lowpyramid"
        if cfg.bezier_degree <= 2
        else "+experiment/multiflow/raft_spline="
        f"{'E_I' if cfg.use_images else 'E'}_LU5_BD10_lowpyramid"
    )
    dataset = (
        "dataset=dsec" if cfg.bezier_degree <= 2
        else "dataset=multiflow_regen"
    )
    return [
        dataset,
        "model=raft-spline",
        exp,
        f"checkpoint={ckpt}",
        "model.precision.corr=float32",
        "model.precision.compute=float32",
        *overrides,
    ]


def main(argv=None, device="cuda") -> Dict[str, Any]:
    """Runs the tool; returns the inferred config and name, the flows by
    mode ('float32', and 'bfloat16' / 'pallas_q8' where asked), the
    relative deltas it printed and the validation's result."""
    from bflow_tpu_torch import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt", nargs="?", default=None,
                    help="reference .ckpt file (omit with --all)")
    ap.add_argument("--all", action="store_true",
                    help="4-family parity table from random-init exports")
    ap.add_argument("overrides", nargs="*",
                    help="val overrides, e.g. dataset.path=...")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--times", default="1.0")
    # 128x128 minimum for the deg-2/deg-10 low-pyramid families: at
    # 96x96 the level-3 map is 1x1 and the reference's grid_sample
    # align_corners normalization divides by (W-1)=0 -> NaN.
    ap.add_argument("--size", type=int, nargs=2, default=(128, 128))
    ap.add_argument("--skip-torch", action="store_true")
    ap.add_argument("--bf16-also", action="store_true")
    ap.add_argument("--q8-also", action="store_true")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    resolve_device(args.device)  # a CUDA device without CUDA raises here

    if args.all:
        return {"rows": run_all(args)}
    if args.ckpt is None:
        ap.error("a .ckpt path is required unless --all is given")

    sd = load_state_dict(args.ckpt)
    cfg, name = infer_config(sd)
    times = tuple(float(t) for t in args.times.split(","))
    print(f"checkpoint: {args.ckpt}")
    print(f"inferred architecture: {name}")

    voxel, images = random_inputs(cfg, args.size)

    def flows(precision, lookup_method=None):
        return our_flow(
            sd=sd, cfg=cfg, voxel_nchw=voxel, images_nchw=images,
            iters=args.iters, times=times, precision=precision,
            lookup_method=lookup_method, device=args.device,
        )

    out: Dict[str, Any] = {"config": cfg, "name": name, "flows": {},
                           "rel": {}, "val": None}
    ours_f32 = out["flows"]["float32"] = flows("float32")

    from bflow_tpu_torch.importer.reference_oracle import (
        reference_available,
        torch_forward_flow,
    )

    if not args.skip_torch and reference_available():
        with full_f32():
            want = torch_forward_flow(
                cfg, sd, voxel, images, iters=args.iters, times=times
            )
        print(f"torch-oracle side-by-side ({args.iters} iters, f32):")
        out["rel"]["f32_vs_torch"] = report("ours-f32 vs torch", ours_f32,
                                            want)
    else:
        print("torch oracle skipped (reference tree unavailable or "
              "--skip-torch)")

    if args.bf16_also or args.q8_also:
        ours_bf16 = out["flows"]["bfloat16"] = flows("bfloat16")
        print("bf16 fast mode vs our f32 parity mode:")
        out["rel"]["bf16_vs_f32"] = report("bf16 vs f32", ours_bf16,
                                           ours_f32)
    if args.q8_also:
        # int8 volume inference mode: the int8 levels of the lookup's
        # level table (csrc/corr_lookup_fwd.cu) on the GPU
        ours_q8 = out["flows"]["pallas_q8"] = flows("bfloat16", "pallas_q8")
        print("q8 volume mode vs bf16 fast mode:")
        out["rel"]["q8_vs_bf16"] = report("q8 vs bf16", ours_q8, ours_bf16)

    ds_overrides = [o for o in args.overrides if "=" in o]
    if ds_overrides:
        print("running full f32 validation (bflow_tpu_torch.val)...")
        from bflow_tpu_torch import val

        out["val"] = val.main(val_argv(cfg, args.ckpt, ds_overrides),
                              device=args.device)
    else:
        print("no dataset.path given: skipped real-data EPE validation "
              "(pass dataset.path=... when the dataset is available)")
    return out


if __name__ == "__main__":
    main()
