"""Training entry point of the port (counterpart of the JAX package's
train.py), on the GPU unless the caller asks for the CPU:

  python -m bflow_tpu_torch.train dataset=multiflow_regen model=raft-spline \\
      dataset.path=<DIR> wandb.group_name=<NAME> \\
      +experiment/multiflow/raft_spline=E_I_LU5_BD10_lowpyramid

  python -m torch.distributed.run --standalone --nproc_per_node=<N> \
      -m bflow_tpu_torch.train <the same overrides>

  from bflow_tpu_torch.train import loop
  loop.main([...overrides...], device="cpu")

The config tree is the JAX package's (bflow_tpu_torch/config, a
byte-identical copy); the device is an argument, not a config key. The
loop is the JAX one: the threaded Loader hands each batch to the device,
the train step keeps its metrics on the device and the loop reads them
back once per log step (step 1 and every `logging.log_every_n_steps`),
with the learning rate and steps/s, then renders media (the eval forward
on the training batch, gradient norms) unless `logging.only_numbers`;
MultiFlow validates every epoch (`val/epe_multi` is the monitor of the
`best` checkpoint), checkpoints are written every
`logging.ckpt_every_n_epochs` and `last` once more when the run ends.
Metrics go to <out_dir>/<group>_<dataset>/train_metrics.csv, and to W&B
where wandb is installed.

Data-parallel training (the counterpart of train.py:107-150,257-345):
`hardware.devices` keeps its JAX meaning, the number of devices of the
data mesh (null: every one there is, torch.cuda.device_count() on CUDA,
1 on the CPU; a list fails, as make_mesh(n_devices=[0, 1]) does). For N
> 1 the loop spawns N ranks itself, one per card (cuda:i) or N CPU
processes under device="cpu", met through a file in a temporary
directory; under torchrun it is one of the launcher's ranks, and N must
be its WORLD_SIZE. An explicit device="cuda:k" puts every rank on card
k, which only backend="gloo" allows (NCCL refuses two ranks on one
card). `training.batch_size` is the global batch: it must divide by the
number of ranks, each of which loads batch_size / N through
shard=(rank, N), trains through the data-parallel train step
(train/step.py) and validates its slice of the val split, its metrics
reduced over the ranks. Only rank 0 prints, writes checkpoints, the CSV,
W&B and media (its own slice of the batch: the JAX package's media path
device_gets a global array, which works in one process only); every rank
restores the full state on resume. The returned counts (samples, val
fields) are global.

Where it differs from the JAX package's loop:
  * Initial weights come from a seeded torch.Generator (seed 0), not from
    JAX's PRNGKey(0) init; a run that must start from given weights takes
    them through `wandb.artifact_name=<path> wandb.resume_only_weights=true`
    (a port checkpoint or a reference `.ckpt`).
  * Checkpoints are torch.save files (`ckpt/last.pt`, `ckpt/best.pt`,
    `ckpt/meta.json`). A `last` in the run directory resumes the full
    state: step, weights and BatchNorm statistics, AdamW's moments and the
    scheduler's position. The run then continues at epoch step //
    batches-per-epoch, after the batches of that epoch it has trained on,
    so a resumed run sees the batches an uninterrupted one would (the JAX
    loop starts again at epoch 0).
  * `hardware.loader=grain` is the port's worker-process loader
    (data/grain_loader.py): the threaded Loader's batches, bit-equal.
  * `debugging.profiler=jax` (the value keeps its name: the config tree is
    the JAX package's) writes a torch.profiler chrome trace of rank 0's
    run into <run_dir>/profile.
  * TF32 is off for matmuls and cuDNN on every rank: the JAX package pins
    f32 matmuls to HIGHEST.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict


def world_size(devices, device) -> int:
    """The number of ranks `hardware.devices` asks for (module
    docstring)."""
    import torch

    from bflow_tpu_torch.parallel.distributed import launched

    if devices is not None and (isinstance(devices, bool)
                                or not isinstance(devices, int)):
        raise TypeError(
            f"hardware.devices={devices!r}: the number of devices (an int) "
            "or null, as the JAX package's make_mesh(n_devices=...) takes")
    if launched():
        world = int(os.environ["WORLD_SIZE"])
        if devices is not None and devices != world:
            raise ValueError(f"hardware.devices={devices} but the launcher "
                             f"started WORLD_SIZE={world} ranks")
        return world
    if devices is not None:
        return devices
    if torch.device("cuda" if device is None else device).type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def main(argv=None, device=None, backend=None,
         timeout_s=None) -> Dict[str, Any]:
    """Runs the training; returns the final step, the run directory, the
    last validation metrics, and the loop's numbers: its training wall,
    the seconds of it spent waiting for the Loader and logging (the
    metric readback, the CSV, media), the samples trained on, the device
    ms of each step (CUDA events; empty on the CPU), the validation
    fields and seconds, and the number of ranks (rank 0's numbers where
    they are per rank; the counts are global). ``backend`` names the
    process group's backend (default: NCCL on CUDA, gloo on the CPU).
    ``timeout_s`` is a deadline for ranks the loop spawns itself
    (distributed.spawn); a training run has none, a test sets one."""
    import torch

    from bflow_tpu_torch import resolve_device
    from bflow_tpu_torch.cli import CONFIG_DIR
    from bflow_tpu_torch.confsys import compose
    from bflow_tpu_torch.parallel import distributed

    overrides = list(argv if argv is not None else sys.argv[1:])
    config = compose(CONFIG_DIR, "train", overrides)
    dev = resolve_device("cuda" if device is None else device)
    world = world_size(config["hardware"].get("devices"), device)
    if world == 1 or distributed.launched():
        return _train(overrides, device=device, backend=backend)
    if dev.type == "cuda":
        if dev.index is None and torch.cuda.device_count() < world:
            raise ValueError(f"{world} ranks, one per card, but there are "
                             f"{torch.cuda.device_count()} cards")
        if dev.index is not None and backend != "gloo":
            raise ValueError(f"device={device!r} puts all {world} ranks on "
                             "one card: only backend='gloo' allows that")
    return distributed.spawn(_train, world, args=(overrides,),
                             device=device, backend=backend,
                             timeout_s=timeout_s)


def _train(overrides, device=None, backend=None) -> Dict[str, Any]:
    """One rank's training. Under torchrun it starts (and ends) the
    process group from the launcher's environment; a spawned rank has
    one already; a single process trains without one."""
    import torch

    from bflow_tpu_torch import resolve_device
    from bflow_tpu_torch.parallel import distributed

    dev = resolve_device(distributed.rank_device(
        device, int(os.environ.get("LOCAL_RANK", 0))))
    # under torchrun the group starts here; spawned ranks have one already
    owns_group = (not distributed.is_initialized()
                  and distributed.initialize_distributed(backend=backend,
                                                         device=dev))
    try:
        return _loop(overrides, dev)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


def _loop(overrides, dev) -> Dict[str, Any]:
    import torch

    from bflow_tpu_torch import build_model
    from bflow_tpu_torch.callbacks.logger import MediaLogger
    from bflow_tpu_torch.cli import (
        CONFIG_DIR,
        backfill_correlation_bins,
        build_provider,
        limit_batches,
        model_config_from,
        supervision_timestamps,
    )
    from bflow_tpu_torch.confsys import compose
    from bflow_tpu_torch.data.keys import DataLoading as K
    from bflow_tpu_torch.data.loader import make_loader
    from bflow_tpu_torch.loggers.csv_logger import CSVLogger
    from bflow_tpu_torch.loggers.wandb_logger import WandbLogger
    from bflow_tpu_torch.parallel import distributed
    from bflow_tpu_torch.train import (
        CheckpointManager,
        TaskConfig,
        TrainState,
        make_eval_step,
        make_train_step,
    )
    from bflow_tpu_torch.train.checkpoint import (
        resolve_artifact_checkpoint,
        restore_weights_only,
    )
    from bflow_tpu_torch.train.step import (
        init_metric_acc,
        metric_acc_means,
        train_metric_keys,
    )
    from bflow_tpu_torch.utils.metrics import MetricBank

    config = compose(CONFIG_DIR, "train", overrides)
    rank, world = distributed.process_index(), distributed.process_count()
    primary = distributed.is_primary_host()
    say = print if primary else (lambda *a, **k: None)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    train_cfg = config["training"]
    dataset_name = config["dataset"]["name"]
    provider = build_provider(config)
    backfill_correlation_bins(config, provider)
    cfg = model_config_from(config)
    model = build_model(cfg, dev, seed=0)

    batch_size = int(train_cfg["batch_size"])
    if batch_size % world:
        raise ValueError(
            f"training.batch_size={batch_size} must be divisible by the "
            f"mesh size ({world}); set hardware.devices or the batch size "
            "accordingly")
    rows = distributed.host_local_batch_slice(batch_size)
    host_batch = rows.stop - rows.start
    hardware = config["hardware"]
    num_workers = hardware.get("num_workers") or min(2 * batch_size, 16)
    loader_kw = dict(kind=hardware.get("loader") or "threaded",
                     batch_size=host_batch, num_workers=num_workers,
                     device=dev, shard=(rank, world) if world > 1 else None)
    train_ds = provider.get_train_dataset()
    loader = make_loader(train_ds, shuffle=True, seed=0, **loader_kw)
    val_loader = None

    if dataset_name == "multiflow_regen":
        task = TaskConfig(
            dataset="multiflow2d",
            multi_loss=bool(train_cfg["multi_loss"]),
            supervision_timestamps=supervision_timestamps(train_ds),
        )
        monitor, mode = "val/epe_multi", "min"
    else:
        task = TaskConfig(dataset="dsec", multi_loss=False)
        monitor, mode = "step", "max"  # DSEC trains without validation

    out_dir = Path(config["logging"].get("out_dir", "./runs"))
    run_name = config["wandb"].get("group_name") or "run"
    run_dir = out_dir / f"{run_name}_{dataset_name}"
    ckpt_mgr = CheckpointManager(str(run_dir / "ckpt"), monitor, mode)

    wandb_cfg = config["wandb"]
    csv_logger = wb = None
    if primary:
        csv_logger = CSVLogger(str(run_dir), "train_metrics")
        wb = WandbLogger(
            project=wandb_cfg.get("project_name", "contflow"),
            group=wandb_cfg.get("group_name"),
            run_id=(
                Path(wandb_cfg["wandb_runpath"]).name
                if wandb_cfg.get("wandb_runpath")
                else None
            ),
            config=config,
        )

    # resume: a W&B artifact or local path (weights only; rank 0 reads it,
    # and the train step hands its weights to every rank), then any 'last'
    # in the run directory (the full state, on every rank)
    if primary:
        ckpt_path = resolve_artifact_checkpoint(wandb_cfg, wb)
        if ckpt_path is not None and wandb_cfg.get("resume_only_weights"):
            restore_weights_only(str(ckpt_path), model)
            say(f"resumed weights from {ckpt_path}")
    state = TrainState.create(model, train_cfg)
    if ckpt_mgr.restore(state, "last") is not None:
        say(f"resumed full training state at step {state.step}")

    log_media = primary and not config["logging"].get("only_numbers", False)
    train_step = make_train_step(model, task, state.optimizer,
                                 state.scheduler, with_grad_norms=log_media)
    eval_step = make_eval_step(model, task)
    media_step = make_eval_step(model, task, over_ranks=False)
    media = MediaLogger(
        wb,
        task.dataset,
        every_n_steps=int(config["logging"].get("log_every_n_steps", 5000)),
        n_val_predictions=int(
            config["logging"].get("log_n_val_predictions", 2)
        ),
        enabled=log_media,
    )

    max_steps = int(train_cfg["max_steps"])
    max_epochs = int(train_cfg["max_epochs"])
    log_every = int(config["logging"].get("log_every_n_steps", 1000))
    ckpt_every = int(config["logging"].get("ckpt_every_n_epochs", 1))
    n_train = limit_batches(train_cfg.get("limit_train_batches"), len(loader))

    profiler = None
    if primary and config["debugging"].get("profiler") == "jax":
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    metric_acc = init_metric_acc(train_metric_keys(task), dev)
    step = state.step
    start_epoch, skip = divmod(step, n_train) if n_train else (0, 0)
    last_log_step, last_log_time = step, time.time()
    t_start = time.time()
    train_s = wait_s = val_s = log_s = 0.0
    samples = val_fields = 0
    step_ms = []
    vvals: Dict[str, float] = {}
    say(f"training: {world} rank(s) ({dev} on rank 0), global batch "
        f"{batch_size} ({host_batch} per rank), {n_train} batches/epoch, "
        f"target {max_steps} steps, from step {step}")

    try:
        for epoch in range(start_epoch, max_epochs):
            if step >= max_steps:
                break
            loader.set_epoch(epoch)
            first = skip if epoch == start_epoch else 0
            t_epoch = time.perf_counter()
            step_events = []
            for batch in loader.iterate(first, n_train):
                if step >= max_steps:
                    break
                if dev.type == "cuda":
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                if log_media:
                    metric_acc, grad_norms = train_step(batch, metric_acc)
                else:
                    metric_acc = train_step(batch, metric_acc)
                    grad_norms = None
                if dev.type == "cuda":
                    events[1].record()
                    step_events.append(events)
                step += 1
                state.step = step
                samples += batch[K.FLOW.value].shape[-4] * world
                if step % log_every == 0 or step == 1:
                    t_log = time.perf_counter()
                    if primary:
                        vals = metric_acc_means(metric_acc)  # one readback
                        vals["learning_rate"] = state.optimizer.param_groups[
                            0]["lr"]
                        now = time.time()
                        vals["steps_per_sec"] = (step - last_log_step) / max(
                            now - last_log_time, 1e-9
                        )
                        last_log_step, last_log_time = step, now
                        csv_logger.log(vals, step)
                        wb.log(vals, step)
                        say(
                            f"step {step}: "
                            + ", ".join(
                                f"{k}={v:.4f}" for k, v in sorted(vals.items())
                            )
                        )
                    metric_acc = init_metric_acc(metric_acc, dev)
                    if media.enabled:
                        _, pred, bez_low = media_step(batch)
                        media.on_train_batch(step, batch, pred,
                                             bezier_params=bez_low)
                        if grad_norms is not None:
                            media.on_after_backward(step, grad_norms)
                        if wb.enabled:
                            wb.log_histograms(model, step)
                    log_s += time.perf_counter() - t_log
            if dev.type == "cuda":
                torch.cuda.current_stream().synchronize()
            train_s += time.perf_counter() - t_epoch
            step_ms += [a.elapsed_time(b) for a, b in step_events]
            wait_s += loader.wait_s

            # validation (MultiFlow; DSEC has none, as in the reference),
            # each rank over its slice, the metrics over the ranks
            epoch_metrics = {"step": float(step)}
            if dataset_name == "multiflow_regen" and limit_batches(
                train_cfg.get("limit_val_batches"), 1
            ) > 0:
                t_val = time.perf_counter()
                val_bank = MetricBank()
                if val_loader is None:
                    val_loader = make_loader(provider.get_val_dataset(),
                                             shuffle=False, **loader_kw)
                n_val = limit_batches(
                    train_cfg.get("limit_val_batches"), len(val_loader)
                )
                media.plan_validation(n_val)
                for v_idx, vbatch in enumerate(val_loader.iterate(0, n_val)):
                    vmetrics, vpred, vbez = eval_step(vbatch)
                    val_bank.update(vmetrics)  # reads the values back
                    media.on_validation_batch(step, v_idx, vbatch, vpred,
                                              bezier_params=vbez)
                    val_fields += vbatch[K.FLOW.value].shape[-4] * world
                vvals = val_bank.compute()
                val_s += time.perf_counter() - t_val
                epoch_metrics.update(vvals)
                if primary:
                    csv_logger.log(vvals, step)
                    wb.log(vvals, step)
                say(f"epoch {epoch} val: "
                    + ", ".join(f"{k}={v:.4f}" for k, v in vvals.items()))

            if primary and (epoch + 1) % ckpt_every == 0:
                info = ckpt_mgr.save(state, epoch_metrics)
                wb.upload_checkpoint(
                    str(ckpt_mgr.path("last")), step,
                    score=epoch_metrics.get(monitor),
                )
                say(f"epoch {epoch}: checkpoint saved "
                    f"(best={info['best_score']})")
    finally:
        if profiler is not None:
            profiler.stop()
            (run_dir / "profile").mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(
                str(run_dir / "profile" / "trace.json"))
        if primary:
            ckpt_mgr.save(state, {"step": float(step)})
            csv_logger.finalize()
            wb.finalize()
    say(f"done at step {step} in {time.time() - t_start:.0f}s"
        + (f", device step median {statistics.median(step_ms):.2f} ms"
           if step_ms else ""))
    return {"step": step, "run_dir": run_dir, "val_metrics": vvals,
            "model_config": cfg, "train_seconds": train_s,
            "loader_wait_seconds": wait_s, "log_seconds": log_s,
            "samples": samples, "step_ms": step_ms,
            "val_fields": val_fields, "val_seconds": val_s, "world": world}


if __name__ == "__main__":
    main()
