"""Command-line entry points of the PyTorch port (port of ``cli.py``).

Mirrors the reference's run-a-script workflow (`python OpenPyStruct_*.py`)
as subcommands of one CLI, with the JAX package's flags and printed lines:

  python -m openpystruct_tpu_torch beam-opt   — single-load beam optimizer
                                                (OpenPyStruct_BeamOpt.py)
  python -m openpystruct_tpu_torch frame-opt  — 2D frame optimizer
                                   (OpenPyStruct_FrameOpt_Discrete_Beta.py)
  python -m openpystruct_tpu_torch datagen    — dataset generation
  python -m openpystruct_tpu_torch train      — any surrogate family on a
                                                dataset (the seven
                                                *_MultiCase scripts)
  python -m openpystruct_tpu_torch predict    — user inference
  python -m openpystruct_tpu_torch bench      — the headline benchmark

Every subcommand runs on the card (``--device cuda``, the default) and exits
with an error where there is none; ``--device cpu`` runs the kernels' plain
versions.  ``--mesh`` (datagen, frame-opt, train) runs data-parallel over
the ranks that ``torchrun`` started, one process per device
(``torchrun --standalone --nproc_per_node N -m openpystruct_tpu_torch
datagen --mesh``); without ``torchrun`` it is one rank.  Only rank 0
prints and writes files.  ``--plot`` and ``--watch`` need matplotlib,
imported only when one is given.

``main(argv)`` returns what the subcommand computed (losses, the valid
count, the prediction, the benchmark's lines), for callers in the same
process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

_FAMILIES = ["fnn", "pinn", "fno", "gnn", "tfd", "bnn", "bnn-meta"]


def _add_device(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda, the card; 'cpu' runs "
                        "the kernels' plain PyTorch versions)")


def _add_beam_opt(sub):
    p = sub.add_parser("beam-opt", help="single-load beam I optimization")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--plot", type=str, default=None,
                   help="save diagnostics figure to this path")
    p.add_argument("--refine", type=int, default=1)
    _add_device(p)


def _add_frame_opt(sub):
    p = sub.add_parser("frame-opt", help="2D frame I optimization")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bays", type=int, default=None,
                   help="default: random 1-10 like the reference")
    p.add_argument("--stories", type=int, default=None)
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--plot", type=str, default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="optimize BATCH load scenarios of this topology in "
                        "one batched run (the reference runs one frame "
                        "per invocation)")
    p.add_argument("--dataset", type=int, default=None,
                   help="generate a MIXED-TOPOLOGY dataset of this many "
                        "samples: topology drawn per sample from the "
                        "reference's random 1-10x1-10 distribution "
                        "(FrameOpt_Discrete_Beta.py:50-52), lanes bucketed "
                        "by topology")
    p.add_argument("--output", type=str, default=None,
                   help="with --batch/--dataset: write the columnar "
                        "results JSON here")
    p.add_argument("--mesh", action="store_true",
                   help="with --batch/--dataset: shard scenarios over the "
                        "ranks torchrun started (one device each)")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="with --batch/--dataset: run lanes in sequential "
                        "chunks of this size to bound peak device memory "
                        "on large topology x batch products")
    p.add_argument("--grad-mode", choices=["semi", "adjoint"],
                   default="semi",
                   help="semi = reference semantics (loss gradient at "
                        "frozen force fields); adjoint = exact gradient "
                        "through the solve (implicit adjoint reusing the "
                        "banded factors)")
    _add_device(p)


def _add_datagen(sub):
    p = sub.add_parser("datagen", help="generate a training dataset")
    p.add_argument("--num-samples", type=int, default=100000)
    p.add_argument("--batch-size", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", type=str, default="training_data_PINN_mini.json")
    p.add_argument("--random-bridge", action="store_true",
                   help="randomize length and roller layout (flag=1)")
    p.add_argument("--num-nodes", type=int, default=None,
                   help="mesh nodes per beam (reference: 101).  The whole "
                        "pipeline — kernels, datagen, train, predict — "
                        "treats mesh size as a free axis; predict reads "
                        "the trained mesh back from the preprocessing "
                        "metadata")
    p.add_argument("--mesh", action="store_true",
                   help="shard each batch over the ranks torchrun started "
                        "(one device each)")
    p.add_argument("--refine", type=int, default=1)
    p.add_argument("--max-epochs", type=int, default=None,
                   help="override the per-sample optimization budget "
                        "(reference: 600)")
    p.add_argument("--grad-mode", choices=["semi", "adjoint"], default=None,
                   help="per-sample optimizer gradient: 'semi' treats the "
                        "FE forces as constants each iteration (the "
                        "reference's fresh-leaf-tensor scheme, "
                        "OpenPyStruct_BeamOpt.py:150-151); 'adjoint' "
                        "differentiates through the solve exactly (on the "
                        "card with --rescue-mode f64 or --no-rescue where "
                        "a rescue runs: the float64 kernels are "
                        "semi-gradient only)")
    p.add_argument("--shard-dir", type=str, default=None,
                   help="crash-safe mode: write per-batch .npz shards here "
                        "(a killed run resumes at the first missing shard) "
                        "and convert them to the JSON output at the end")
    p.add_argument("--no-compact", action="store_true",
                   help="disable converged-lane compaction (compaction is "
                        "on by default for batches >= 2048)")
    p.add_argument("--no-rescue", action="store_true",
                   help="with --random-bridge: drop the ill-conditioned "
                        "tail instead of re-optimizing it in float64 "
                        "(faster, but the kept-sample distribution then "
                        "diverges from the reference's)")
    p.add_argument("--rescue-mode", choices=["dd", "f64"], default=None,
                   help="rescue arithmetic: 'dd' = the float64 rescue "
                        "kernels on the card (default there), 'f64' = "
                        "host-CPU float64 re-optimization (default on the "
                        "CPU)")
    p.add_argument("--profile", type=str, default=None,
                   help="capture a torch.profiler host + device trace of "
                        "the generation into this directory (Chrome trace "
                        "JSON, with the datagen path's spans)")
    _add_device(p)


def _add_train(sub):
    p = sub.add_parser("train", help="train a surrogate family")
    p.add_argument("--model", required=True, choices=_FAMILIES)
    p.add_argument("--data", required=True, help="dataset JSON path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=None,
                   help="override the family's reference epoch budget")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default=None,
                   help="model compute precision (the reference's AMP "
                        "analog); default: the family's reference setting "
                        "(bfloat16 everywhere but the FNO, which is pinned "
                        "float32)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="file for the best model's torch.save checkpoint; "
                        "the full resumable train state goes to the "
                        "directory <checkpoint>_state")
    p.add_argument("--resume", action="store_true",
                   help="resume from <checkpoint>_state if it exists")
    p.add_argument("--epochs-per-sync", type=int, default=10)
    p.add_argument("--mesh", action="store_true",
                   help="train data-parallel over the ranks torchrun "
                        "started (one device each)")
    p.add_argument("--shuffle-scope", choices=["global", "per_shard"],
                   default="global",
                   help="per_shard: each rank shuffles its own rows, which "
                        "never move (with --mesh over more than one rank)")
    p.add_argument("--plot", type=str, default=None)
    p.add_argument("--watch", type=str, default=None,
                   help="live training plot: PNG path atomically rewritten "
                        "each sync chunk (the reference's plt.ion live_plot "
                        "for headless hosts)")
    p.add_argument("--metrics-jsonl", type=str, default=None,
                   help="append one JSON line per epoch (train_loss, "
                        "val_loss, step, time) to this file — the "
                        "structured upgrade of the reference's print() "
                        "logging (utils.MetricsLogger)")
    p.add_argument("--tensorboard", type=str, default=None,
                   help="write per-epoch scalars as TensorBoard event "
                        "files into this directory (first-party "
                        "zero-dependency event writer)")
    p.add_argument("--profile", type=str, default=None,
                   help="capture a torch.profiler host + device trace of "
                        "the training run into this directory (Chrome "
                        "trace JSON)")
    _add_device(p)


def _add_predict(sub):
    p = sub.add_parser(
        "predict",
        help="user inference: predict I(x) for a multi-case load scenario",
    )
    p.add_argument("--model", required=True, choices=_FAMILIES)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--preproc", required=True,
                   help="preprocessing .npz saved by `train`")
    p.add_argument("--length", type=float, default=200.0)
    p.add_argument("--rollers-x", type=str, default="18,58,138,170,200",
                   help="comma-separated roller positions (m); the "
                        "reference example (FNN_MultiCase.py:645)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mc-samples", type=int, default=0,
                   help="Monte-Carlo forward passes for Bayesian "
                        "uncertainty (the Meta script uses 50)")
    p.add_argument("--plot", type=str, default=None)
    _add_device(p)


def _add_bench(sub):
    p = sub.add_parser("bench", help="run the headline benchmark")
    p.add_argument("--profile", type=str, default=None,
                   help="capture a torch.profiler trace of the benchmark "
                        "into this directory")
    _add_device(p)


def _device(args):
    """The subcommand's device; exits with the error where it is missing."""
    from openpystruct_tpu_torch.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")


def _mesh(args):
    """``--mesh``: join torchrun's process group (``initialize_multihost``,
    on the subcommand's device: NCCL on the card, gloo on the CPU; one
    process when torchrun is absent) and return its ``default_mesh``;
    without the flag None.  A group made here is left by ``main``."""
    if not args.mesh:
        return None
    import torch.distributed as dist

    from openpystruct_tpu_torch.parallel import (
        default_mesh,
        initialize_multihost,
    )

    had_group = dist.is_initialized()
    initialize_multihost(device=args.device)
    args.own_group = dist.is_initialized() and not had_group
    return default_mesh(device=None if args.device == "cuda"
                        else args.device)


def _say(mesh):
    """``print`` on rank 0 (or without a mesh), a no-op on the others."""
    if mesh is None or mesh.rank == 0:
        return print
    return lambda *a, **k: None


def _np(t):
    return t.detach().cpu().numpy()


def cmd_beam_opt(args):
    import numpy as np
    import torch

    from openpystruct_tpu_torch.config import BeamConfig, OptimizerConfig
    from openpystruct_tpu_torch.fem import BeamScenario
    from openpystruct_tpu_torch.opt import optimize_beam

    dev = _device(args)
    # BeamOpt's own scenario distribution: 5 rollers with 15-node minimum
    # spacing, 5 forces in [max/2, max], udl -5000
    # (OpenPyStruct_BeamOpt.py:24-80), drawn with numpy on the host.
    rng = np.random.default_rng(args.seed)
    n, L = 101, 200.0
    rollers = []
    avail = list(range(2, n))
    while len(rollers) < 5 and avail:
        cand = int(rng.choice(avail))
        if all(abs(cand - r) >= 15 for r in rollers):
            rollers.append(cand)
        avail.remove(cand)
    force_nodes = rng.choice(
        [x for x in range(2, n) if x not in rollers], size=5, replace=False
    )
    # random.uniform(0.5*max_force, max_force) in the reference spans
    # [-355857, -177928.5] regardless of argument order
    force_vals = rng.uniform(-355857.0, 0.5 * -355857.0, size=5)

    roller_mask = torch.zeros(n, dtype=torch.bool)
    roller_mask[torch.as_tensor(rollers) - 1] = True
    loads = torch.zeros(n, dtype=torch.float32)
    loads[torch.as_tensor(force_nodes) - 1] = torch.as_tensor(
        force_vals, dtype=torch.float32)
    sc = BeamScenario(
        node_x=torch.linspace(0.0, L, n, dtype=torch.float32),
        roller_mask=roller_mask, point_loads=loads,
        udl=torch.tensor(-5000.0, dtype=torch.float32),
    ).map(lambda t: t.to(dev))
    beam = BeamConfig(udl=-5000.0)
    opt = OptimizerConfig(max_epochs=args.epochs)
    t0 = time.time()
    res = optimize_beam(sc, beam, opt, refine=args.refine,
                        record_history=True)
    ne = int(res.n_epochs)
    h = _np(res.loss_history)
    print(f"converged={bool(res.converged)} epochs={ne} "
          f"wall={time.time()-t0:.2f}s")
    print(f"Total Loss: {h[ne-1,0]:.6f}")
    print(f"Primary Loss: {h[ne-1,1]:.6f}")
    print(f"Bending Energy: {h[ne-1,2]:.6f}, Shear Energy: {h[ne-1,3]:.6f}")
    if args.plot:
        from openpystruct_tpu_torch.viz import (
            plot_beam_diagrams,
            plot_loss_history,
        )

        fig = plot_beam_diagrams(
            _np(sc.node_x), _np(res.I), _np(res.solution.shear_forces),
            _np(res.solution.bending_moments),
            roller_idx=[r - 1 for r in rollers],
            force_idx=(force_nodes - 1).tolist(),
            force_values=force_vals.tolist(),
        )
        fig.savefig(args.plot)
        plot_loss_history(h).savefig(args.plot + ".loss.png")
        print(f"plots saved to {args.plot}")
    return h[:ne]


def cmd_frame_opt(args):
    import random as pyrandom

    import numpy as np
    import torch

    from openpystruct_tpu_torch.config import FrameConfig
    from openpystruct_tpu_torch.fem import build_frame
    from openpystruct_tpu_torch.opt import optimize_frame

    dev = _device(args)
    mesh = _mesh(args)
    dev = dev if mesh is None else mesh.device
    say = _say(mesh)
    pyrandom.seed(args.seed)
    cfg = FrameConfig(max_epochs=args.epochs)
    if args.dataset:
        from openpystruct_tpu_torch.datagen import generate_frame_dataset

        t0 = time.time()
        data = generate_frame_dataset(
            args.seed, args.dataset, cfg,
            bays_range=(args.bays, args.bays) if args.bays else (1, 10),
            stories_range=(args.stories, args.stories)
            if args.stories else (1, 10),
            verbose=say is print, chunk_size=args.chunk_size,
            grad_mode=args.grad_mode, device=dev, mesh=mesh,
        )
        dt = time.time() - t0
        topos = sorted(set(zip(data["num_bays"], data["num_stories"])))
        say(f"{len(data['I_values'])} samples over {len(topos)} distinct "
            f"topologies in {dt:.1f}s")
        if args.output and say is print:
            with open(args.output, "w") as fh:
                json.dump(data, fh)
            say(f"dataset written to {args.output}")
        return data
    bays = args.bays or pyrandom.randint(1, 10)
    stories = args.stories or pyrandom.randint(1, 10)
    say(f"Generated frame with {bays} bay(s) and {stories} story(ies).")
    if args.batch:
        from openpystruct_tpu_torch.datagen import (
            frame_batch_to_columnar,
            generate_frame_batch,
        )

        t0 = time.time()
        st, batch = generate_frame_batch(
            torch.Generator().manual_seed(args.seed), args.batch, bays,
            stories, cfg, chunk_size=args.chunk_size,
            grad_mode=args.grad_mode, device=dev, mesh=mesh,
        )
        valid = int(batch.valid.sum())
        dt = time.time() - t0
        say(f"{args.batch} load scenarios optimized in {dt:.1f}s "
            f"({valid} valid, {args.batch/dt:.1f} frames/s)")
        if args.output and say is print:
            cols = frame_batch_to_columnar(st, batch)
            with open(args.output, "w") as fh:
                json.dump(cols, fh)
            say(f"results written to {args.output}")
        return batch
    st = build_frame(bays, stories, cfg, device=dev)
    t0 = time.time()
    res = optimize_frame(st, cfg, record_history=True,
                         grad_mode=args.grad_mode)
    ne = int(res.n_epochs)
    h = _np(res.loss_history)
    say(f"converged={bool(res.converged)} epochs={ne} "
        f"wall={time.time()-t0:.2f}s  best loss={np.nanmin(h):.6e}")
    if args.plot and say is print:
        from openpystruct_tpu_torch.viz import plot_frame

        plot_frame(st, _np(res.I)).savefig(args.plot)
        say(f"plot saved to {args.plot}")
    return float(np.nanmin(h))


def cmd_datagen(args):
    import dataclasses

    from openpystruct_tpu_torch.config import DATAGEN_OPT, ScenarioConfig
    from openpystruct_tpu_torch.datagen import (
        generate_dataset_json,
        generate_to_shards,
        read_json_dataset,
        shards_to_json,
    )

    dev = _device(args)
    mesh = _mesh(args)
    dev = dev if mesh is None else mesh.device
    say = _say(mesh)
    scen = ScenarioConfig(random_bridge=args.random_bridge)
    if args.num_nodes:
        scen = dataclasses.replace(scen, num_nodes=args.num_nodes)
    opt_cfg = DATAGEN_OPT
    if args.max_epochs:
        opt_cfg = dataclasses.replace(opt_cfg, max_epochs=args.max_epochs)
    if args.grad_mode:
        opt_cfg = dataclasses.replace(opt_cfg, grad_mode=args.grad_mode)
    done = 0

    def progress(batch):
        nonlocal done
        done += batch.valid.shape[0]
        say(f"{done} samples processed.", flush=True)

    kw = dict(batch_size=args.batch_size, on_batch=progress, scen_cfg=scen,
              opt_cfg=opt_cfg, refine=args.refine,
              compact=False if args.no_compact else None,
              rescue=False if args.no_rescue else args.rescue_mode,
              device=dev, mesh=mesh)
    lead = say is print
    profile_ctx = contextlib.nullcontext()
    if lead and args.profile:
        from openpystruct_tpu_torch.utils import profile_trace

        profile_ctx = profile_trace(args.profile)
    t0 = time.time()
    with profile_ctx:
        if args.shard_dir:
            paths = generate_to_shards(args.seed, args.num_samples,
                                       args.shard_dir, **kw)
        else:
            n = generate_dataset_json(args.seed, args.num_samples,
                                      args.output, **kw)
    if not lead:
        return None if args.shard_dir else n   # rank 0 converts the shards
    if args.shard_dir:
        n = shards_to_json(paths, args.output)
    dt = time.time() - t0
    print("Data generation complete.")
    print(f"Total execution time: {dt:.2f} seconds "
          f"({n / dt:.0f} samples/sec); {n} valid samples -> {args.output}")
    # Post-run sanity reload: re-open the artifact from DISK (via the native
    # reader) and report per-key entry counts — the reference's only
    # output-integrity check
    # (OpenPyStruct_BeamOpt_training_SingleCore.py:274-283).
    back = read_json_dataset(args.output)
    print("Data loaded successfully!")
    print(f"Number of samples: {len(back['roller_x_locations'])}")
    print("Keys available in the dataset:")
    for key in back:
        print(f"- {key} (Number of entries: {len(back[key])})")
    if len(back["I_values"]) != n:
        print(f"WARNING: reload count {len(back['I_values'])} != "
              f"written count {n}")
    return n


def cmd_train(args):
    import dataclasses
    import os

    from openpystruct_tpu_torch.data import prepare_dataset
    from openpystruct_tpu_torch.datagen import read_json_dataset
    from openpystruct_tpu_torch.families import FAMILIES, build_family
    from openpystruct_tpu_torch.train import (
        evaluate_r2,
        fit,
        save_checkpoint,
    )

    dev = _device(args)
    mesh = _mesh(args)
    dev = dev if mesh is None else mesh.device
    say = _say(mesh)
    lead = say is print
    spec = FAMILIES[args.model]
    cfg = spec.train
    if args.epochs:
        cfg = dataclasses.replace(cfg, num_epochs=args.epochs)
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)

    data = read_json_dataset(args.data)
    ds = prepare_dataset(
        data, n_cases=cfg.n_cases, c=cfg.c, agg=spec.agg, seed=args.seed,
        nheads_pad=spec.nheads_pad, extra_label_keys=spec.extra_label_keys,
    )
    nelem = len(data["I_values"][0])
    model, spec, fit_kwargs = build_family(
        args.model, ds.feat_dim, nelem=nelem, label_dim=ds.label_dim,
        compute_dtype=args.compute_dtype,
    )
    state_dir = args.checkpoint + "_state" if args.checkpoint else None
    resume_from = None
    if args.resume and state_dir and os.path.isdir(state_dir):
        resume_from = state_dir
        say(f"resuming from {state_dir}")
    metrics = None
    if lead and (args.metrics_jsonl or args.tensorboard):
        from openpystruct_tpu_torch.utils import MetricsLogger

        metrics = MetricsLogger(jsonl=args.metrics_jsonl,
                                tensorboard_dir=args.tensorboard)
    profile_ctx = contextlib.nullcontext()
    if lead and args.profile:
        from openpystruct_tpu_torch.utils import profile_trace

        profile_ctx = profile_trace(args.profile)
    X_tr, Y_tr = ds.X_train, ds.Y_train
    if mesh is not None:
        # every rank read the same file and split: it trains on its share
        n, w, r = len(X_tr), mesh.world_size, mesh.rank
        X_tr, Y_tr = (a[r * n // w:(r + 1) * n // w] for a in (X_tr, Y_tr))
    t0 = time.time()
    with profile_ctx:
        res = fit(
            model, X_tr, Y_tr, ds.X_val, ds.Y_val, cfg,
            seed=args.seed, mesh=mesh, shuffle_scope=args.shuffle_scope,
            epochs_per_sync=args.epochs_per_sync, verbose=lead,
            metrics=metrics, live_plot=args.watch if lead else None,
            checkpoint_dir=state_dir, resume_from=resume_from, device=dev,
            **fit_kwargs,
        )
    dt = time.time() - t0
    if metrics is not None:
        metrics.close()
    # The PINN's headline metric is R^2 on the I slice only
    # (OpenPyStruct_PINN_MultiCase.py:831-852).
    label_slice = slice(0, nelem) if args.model == "pinn" else None
    r2 = evaluate_r2(model, res.params, ds.X_val, ds.Y_val, ds.scaler_Y,
                     label_slice=label_slice, batch_size=4096, device=dev)
    ep = len(res.train_losses)
    say(f"{ep} epochs in {dt:.1f}s "
        f"({ep * len(ds.X_train) / dt:.0f} samples/sec)")
    suffix = " (I only)" if label_slice is not None else ""
    say(f"R² on Validation{suffix}: {r2:.4f}")
    if args.checkpoint and lead:
        from openpystruct_tpu_torch.data import save_preprocessing

        save_checkpoint(args.checkpoint, {"params": res.params})
        save_preprocessing(ds, args.checkpoint + "_preproc.npz",
                           nelem=nelem)
        print(f"best checkpoint saved to {args.checkpoint} "
              f"(+ {args.checkpoint}_preproc.npz)")
    if args.plot and lead:
        from openpystruct_tpu_torch.viz import plot_train_val_losses

        plot_train_val_losses(res.train_losses, res.val_losses).savefig(
            args.plot
        )
    return res, r2


def cmd_predict(args):
    import numpy as np

    from openpystruct_tpu_torch.data import (
        build_user_input,
        load_preprocessing,
    )
    from openpystruct_tpu_torch.families import build_family
    from openpystruct_tpu_torch.train import load_checkpoint, predict

    dev = _device(args)
    pre = load_preprocessing(args.preproc)
    n_cases = pre["n_cases"]
    # mesh size travels with the preprocessing metadata (the training
    # dataset's element count); files without it -> the reference's fixed
    # 100-element mesh (FNN_MultiCase.py:660)
    nelem = pre["nelem"] or 100
    print(f"mesh: {nelem} elements (from preprocessing metadata)")
    model, spec, _ = build_family(
        args.model, pre["feat_dim"], nelem=nelem,
        label_dim=pre["label_dim"],
    )
    params = load_checkpoint(args.checkpoint)["params"]

    # the reference's example inference: fixed rollers per case, 1-3 random
    # point forces per case in [Fmax, Fmax/10]
    # (OpenPyStruct_FNN_MultiCase.py:641-681)
    rng = np.random.default_rng(args.seed)
    L = args.length
    rollers = [float(x) for x in args.rollers_x.split(",")]
    user_roller = [rollers[:] for _ in range(n_cases)]
    user_fx, user_fv = [], []
    for _ in range(n_cases):
        k = int(rng.integers(1, 4))
        user_fx.append(sorted(rng.uniform(0, L, k).tolist()))
        user_fv.append(rng.uniform(-355857.0, -35585.7, k).tolist())
    user_nodes = [np.linspace(0, L, nelem + 1).tolist()] * n_cases

    X = build_user_input(
        user_roller, user_fx, user_fv, user_nodes, pre["scalers"],
        n_cases, pre["max_lengths"],
    )
    # zero-pad to the nheads-padded training feature width, like the
    # pipeline does for the transformer families
    if X.shape[-1] < pre["feat_dim"]:
        X = np.pad(
            X, ((0, 0), (0, 0), (0, pre["feat_dim"] - X.shape[-1]))
        )
    if args.mc_samples and args.model in ("bnn", "bnn-meta"):
        from openpystruct_tpu_torch.models import mc_output_stats

        mean, std = mc_output_stats(
            model, params, X, n_samples=args.mc_samples, seed=args.seed,
            scaler_Y=pre["scaler_Y"], device=dev,
        )
        mean_I, std_I = _np(mean)[0][:nelem], _np(std)[0][:nelem]
        print("elem :  mean I (m^4)  : std I (m^4)")
        for i, (m, s) in enumerate(zip(mean_I, std_I)):
            print(f"{i + 1:4d} : {m: .6e} : {s:.3e}")
        pred = mean_I
    else:
        out = _np(predict(model, params, X, pre["scaler_Y"], seed=args.seed,
                          device=dev))
        pred = out[0][:nelem]
        print("predicted I (m^4):")
        print(np.array2string(pred, precision=5, max_line_width=100))
    if args.plot:
        if args.model == "pinn" and pre["label_dim"] > nelem:
            # the PINN predicts I + deflections + rotations: render the
            # reference's 3-panel diagnostic figure
            # (OpenPyStruct_PINN_MultiCase.py:1021-1146)
            from openpystruct_tpu_torch.viz import plot_pinn_panels

            full = out[0]
            aux = (pre["label_dim"] - nelem) // 2
            fig = plot_pinn_panels(
                L, pred, full[nelem : nelem + aux],
                full[nelem + aux : nelem + 2 * aux],
                rollers_x=rollers, force_cases_x=user_fx,
                force_cases_vals=user_fv,
            )
        else:
            from openpystruct_tpu_torch.viz import plot_beam_prediction

            fig = plot_beam_prediction(
                L, pred, rollers_x=rollers, force_cases_x=user_fx,
                force_cases_vals=user_fv,
            )
        fig.savefig(args.plot)
        print(f"plot saved to {args.plot}")
    return pred


def cmd_bench(args):
    from openpystruct_tpu_torch import bench

    dev = _device(args)
    ctx = contextlib.nullcontext()
    if args.profile:
        from openpystruct_tpu_torch.utils import profile_trace

        ctx = profile_trace(args.profile)
    with ctx:
        return bench.run(device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="openpystruct_tpu_torch",
        description="structural optimization framework, PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_beam_opt(sub)
    _add_frame_opt(sub)
    _add_datagen(sub)
    _add_train(sub)
    _add_predict(sub)
    _add_bench(sub)
    args = ap.parse_args(argv)
    try:
        return {
            "beam-opt": cmd_beam_opt,
            "frame-opt": cmd_frame_opt,
            "datagen": cmd_datagen,
            "train": cmd_train,
            "predict": cmd_predict,
            "bench": cmd_bench,
        }[args.cmd](args)
    finally:
        if getattr(args, "own_group", False):
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
