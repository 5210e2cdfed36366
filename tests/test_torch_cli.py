"""Port: the command-line surface (``cli.py``, ``bench.py``) against the JAX
package's ``cli.py``, in process on the CPU (``--device cpu``).

- ``beam-opt --epochs 8 --refine 0``: the same numpy-drawn scenario as
  JAX's ``cmd_beam_opt``, bitwise; on it the two optimizers in float64
  within 1e-6; the printed float32 losses within 1e-2 (each package's
  float32 solve without refinement is ~0.5-1% off float64 here).
- ``frame-opt --bays 2 --stories 1 --epochs 10``: the best loss within 1e-5
  relative of JAX's; ``--batch 6 --output`` writes 6 rows with the JAX
  package's columnar keys.
- ``datagen`` (48 samples, 15 epochs), plain at 101 nodes and
  ``--shard-dir`` on a 21-node random bridge: files that JAX's
  ``read_json_dataset`` reads with the 13 keys and the printed count.  The
  samples differ from JAX's by design (torch generators).
- ``train --model fnn`` with every observability flag: one JSONL line and
  two TensorBoard scalars per epoch, a profiler trace, the watch PNG and
  the loss plot (where matplotlib imports), a checkpoint and a
  ``_preproc.npz`` that JAX's ``load_preprocessing`` reads as the port's.
- ``predict``: JAX's ``cmd_predict`` on an orbax checkpoint of flax
  parameters and the port's on the same weights carried by ``interop``
  agree within 1e-5 relative: the FNN, and ``bnn --mc-samples 8`` (mean;
  the draws patched to one per shape in both packages, so both stds are
  0).  Both families run in float32 here (their table entries patched):
  in bfloat16 the two packages' forwards differ by bfloat16 rounding
  (``tests/test_torch_fnn_pinn.py``, ``tests/test_torch_bayesian.py``).
- ``bench``: its functions at tiny sizes print the three lines, in order,
  with finite positive values.
- The device rule and the refused flags: a missing card without
  ``--device cpu``, ``--mesh`` and ``--shuffle-scope per_shard`` exit
  non-zero with their message; ``python -m openpystruct_tpu_torch`` runs.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu import cli as jcli
from openpystruct_tpu import families as jfam
from openpystruct_tpu.data import load_preprocessing as jload_pre
from openpystruct_tpu.datagen import read_json_dataset as jread
from openpystruct_tpu.train import save_checkpoint as jsave
from openpystruct_tpu_torch import bench, cli
from openpystruct_tpu_torch import families as tfam
from openpystruct_tpu_torch.data import load_preprocessing, prepare_dataset
from openpystruct_tpu_torch.data import save_preprocessing
from openpystruct_tpu_torch.datagen import SCHEMA_KEYS, read_json_dataset
from openpystruct_tpu_torch.interop import (
    bnn_params_from_flax,
    fnn_params_from_flax,
)
from openpystruct_tpu_torch.models import bayesian as tbayes
from openpystruct_tpu_torch.train import save_checkpoint
from openpystruct_tpu_torch.utils.tb_writer import read_scalars

REPO = Path(__file__).resolve().parent.parent
CPU = ("--device", "cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numbers(text, label):
    return [float(x) for x in re.findall(
        re.escape(label) + r"\s*(-?[\d.]+(?:e[-+]?\d+)?)", text)]


def test_beam_opt_matches_jax(capsys, monkeypatch):
    """The same scenario, the same optimizer: both packages' CLIs draw the
    same scenario (bitwise), and on it the port's ``optimize_beam`` in
    float64 follows JAX's within 1e-6.  The CLIs' own float32 runs without
    refinement are each ~0.5-1% off float64 in the bending energy after 8
    epochs (different rounding), so their printed losses are held to 1e-2:
    the 1e-4 asked of them holds in float64 only (measured here: total
    1.2e-3 and bending energy 4.9e-3 apart)."""
    import openpystruct_tpu.fem as jfem
    from openpystruct_tpu.config import BeamConfig as JBeam
    from openpystruct_tpu.config import OptimizerConfig as JOpt
    from openpystruct_tpu.opt import optimize_beam as joptimize
    from openpystruct_tpu_torch import opt as topt
    from openpystruct_tpu_torch.config import BeamConfig, OptimizerConfig

    seen = {}
    real_sc, real_opt = jfem.BeamScenario, topt.optimize_beam
    monkeypatch.setattr(jfem, "BeamScenario", lambda **kw: seen.setdefault(
        "jax", real_sc(**kw)))
    monkeypatch.setattr(topt, "optimize_beam", lambda sc, *a, **k: (
        seen.setdefault("port", sc), real_opt(sc, *a, **k))[1])
    args = ["beam-opt", "--epochs", "8", "--refine", "0"]
    with jax.enable_x64(False):     # the JAX package's default: float32
        jcli.main(args)
    jout = capsys.readouterr().out
    hist = cli.main(args + list(CPU))
    tout = capsys.readouterr().out
    assert "epochs=8" in jout and "epochs=8" in tout and hist.shape == (8, 4)
    for name in ("node_x", "roller_mask", "point_loads", "udl"):
        np.testing.assert_array_equal(
            getattr(seen["port"], name).numpy(),
            np.asarray(getattr(seen["jax"], name)), name)
    for label in ("Total Loss:", "Primary Loss:", "Bending Energy:",
                  "Shear Energy:"):
        (j,), (t,) = _numbers(jout, label), _numbers(tout, label)
        assert abs(t - j) <= 1e-2 * abs(j), (label, t, j)
    (t,) = _numbers(tout, "Total Loss:")
    assert abs(hist[-1, 0] - t) <= 1e-6 * abs(t)
    # float64 on the captured scenario: the optimizers agree to the
    # float64 solve's own rounding on this 200 m span (measured 2e-7)
    sc64 = seen["port"].map(lambda x: x.double() if x.is_floating_point()
                            else x)
    jsc = real_sc(**{k: jnp.asarray(getattr(sc64, k).numpy()) for k in (
        "node_x", "roller_mask", "point_loads", "udl")})
    jres = jax.jit(lambda s: joptimize(
        s, JBeam(udl=-5000.0), JOpt(max_epochs=8), refine=0,
        record_history=True))(jsc)
    tres = real_opt(sc64, BeamConfig(udl=-5000.0),
                    OptimizerConfig(max_epochs=8), refine=0,
                    record_history=True)
    np.testing.assert_allclose(tres.loss_history.numpy(),
                               np.asarray(jres.loss_history), rtol=1e-6)
    np.testing.assert_allclose(tres.I.numpy(), np.asarray(jres.I),
                               rtol=1e-6)


def test_frame_opt_matches_jax(capsys, tmp_path):
    args = ["frame-opt", "--bays", "2", "--stories", "1", "--epochs", "10"]
    jcli.main(args)
    (j,) = _numbers(capsys.readouterr().out, "best loss=")
    t = cli.main(args + list(CPU))
    out = capsys.readouterr().out
    assert "Generated frame with 2 bay(s) and 1 story(ies)." in out
    assert abs(t - j) <= 1e-5 * abs(j), (t, j)
    # --batch: the columnar file, with the JAX package's keys
    tpath, jpath = tmp_path / "t.json", tmp_path / "j.json"
    cli.main(args + ["--batch", "6", "--output", str(tpath), *CPU])
    assert "6 load scenarios optimized" in capsys.readouterr().out
    jcli.main(args + ["--batch", "6", "--output", str(jpath)])
    tcols, jcols = json.loads(tpath.read_text()), json.loads(jpath.read_text())
    assert tcols.keys() == jcols.keys()
    assert len(tcols["I_values"]) == 6 and len(tcols["I_values"][0]) == 5
    assert (tcols["num_bays"], tcols["num_stories"]) == (2, 1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """datagen, plain and sharded, then train fnn with every flag."""
    d = tmp_path_factory.mktemp("cli")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    n_plain = cli.main(["datagen", "--num-samples", "48", "--batch-size",
                        "48", "--max-epochs", "15", "--refine", "0",
                        "--output", str(d / "ds.json"), *CPU])
    n_shard = cli.main(["datagen", "--num-samples", "48", "--batch-size",
                        "24", "--max-epochs", "15", "--refine", "0",
                        "--random-bridge", "--num-nodes", "21",
                        "--shard-dir", str(d / "shards"), "--output",
                        str(d / "ds21.json"), *CPU])
    flags = ["--metrics-jsonl", str(d / "m.jsonl"), "--tensorboard",
             str(d / "tb"), "--profile", str(d / "prof")]
    try:
        import matplotlib  # noqa: F401

        flags += ["--watch", str(d / "watch.png"), "--plot",
                  str(d / "loss.png")]
    except ImportError:
        pass
    res, r2 = cli.main(["train", "--model", "fnn", "--data",
                        str(d / "ds.json"), "--epochs", "3",
                        "--epochs-per-sync", "2", "--checkpoint",
                        str(d / "fnn.pt"), *flags, *CPU])
    torch.set_num_threads(threads)
    return dict(dir=d, n_plain=n_plain, n_shard=n_shard, res=res, r2=r2,
                flags=flags)


@pytest.mark.parametrize("name,count", [("ds.json", "n_plain"),
                                        ("ds21.json", "n_shard")])
def test_datagen_file_read_by_jax(files, name, count):
    data = jread(str(files["dir"] / name))
    assert tuple(data) == SCHEMA_KEYS
    n = files[count]
    assert n > 0 and all(len(v) == n for v in data.values())
    nodes = 101 if name == "ds.json" else 21
    assert len(data["I_values"][0]) == nodes - 1
    assert len(data["node_positions"][0]) == nodes
    if name == "ds21.json":
        assert len(list((files["dir"] / "shards").glob("*.npz"))) == 2


def test_train_observability(files):
    d, res = files["dir"], files["res"]
    assert len(res.train_losses) == 3 and math.isfinite(files["r2"])
    lines = [json.loads(s) for s in (d / "m.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert [x["train_loss"] for x in lines] == res.train_losses.tolist()
    (events,) = (d / "tb").iterdir()
    sc = read_scalars(str(events))
    assert [(s, k) for s, k, _ in sc] == [
        (e, k) for e in (1, 2, 3) for k in ("train_loss", "val_loss")]
    assert [v for _, k, v in sc if k == "val_loss"] == [
        float(np.float32(v)) for v in res.val_losses]
    (trace,) = (d / "prof").iterdir()
    assert "traceEvents" in json.loads(trace.read_text())
    if "--watch" in files["flags"]:
        for png in ("watch.png", "loss.png"):
            assert (d / png).stat().st_size > 1000
    # the preprocessing file: the JAX package reads what the port reads
    pre, jpre = (f(str(d / "fnn.pt_preproc.npz"))
                 for f in (load_preprocessing, jload_pre))
    for k in ("max_lengths", "n_cases", "feat_dim", "label_dim", "nelem"):
        assert pre[k] == jpre[k], k
    assert pre["nelem"] == 100
    for name, s in pre["scalers"].items():
        np.testing.assert_array_equal(s.mean, jpre["scalers"][name].mean)
        np.testing.assert_array_equal(s.scale, jpre["scalers"][name].scale)
    np.testing.assert_array_equal(pre["scaler_Y"].mean,
                                  jpre["scaler_Y"].mean)


def _float32(monkeypatch, name):
    """Run the family in float32 in both packages."""
    for mod in (tfam, jfam):
        spec = mod.FAMILIES[name]
        monkeypatch.setitem(mod.FAMILIES, name, dataclasses.replace(
            spec, train=dataclasses.replace(spec.train,
                                            compute_dtype="float32")))


def _predict_both(monkeypatch, capsys, tmp_path, name, pre_path, flax_params,
                  carry, extra=()):
    jck = str(tmp_path / f"j_{name}")
    jsave(jck, {"params": {"model": flax_params,
                           "alpha": np.float32(0.5)}})
    tck = str(tmp_path / f"t_{name}.pt")
    save_checkpoint(tck, {"params": carry(
        {"model": flax_params, "alpha": np.float32(0.5)}, device="cpu")})
    seen = []
    real = np.array2string
    monkeypatch.setattr(np, "array2string", lambda a, *x, **k: (
        seen.append(np.array(a)), real(a, *x, **k))[1])
    args = ["predict", "--model", name, "--preproc", pre_path, *extra]
    jcli.main(args + ["--checkpoint", jck])
    jout = capsys.readouterr().out
    pred = cli.main(args + ["--checkpoint", tck, *CPU])
    tout = capsys.readouterr().out
    assert "mesh: 100 elements (from preprocessing metadata)" in tout
    return jout, tout, pred, seen


def test_predict_fnn_matches_jax(files, monkeypatch, capsys, tmp_path):
    _float32(monkeypatch, "fnn")
    pre_path = str(files["dir"] / "fnn.pt_preproc.npz")
    pre = load_preprocessing(pre_path)
    jm, _, _ = jfam.build_family("fnn", pre["feat_dim"], nelem=100,
                                 label_dim=pre["label_dim"])
    params = jax.tree.map(np.asarray, jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5)},
        jnp.zeros((1, pre["n_cases"], pre["feat_dim"]))))()["params"])
    jout, tout, pred, seen = _predict_both(
        monkeypatch, capsys, tmp_path, "fnn", pre_path, params,
        fnn_params_from_flax)
    assert "predicted I (m^4):" in jout and "predicted I (m^4):" in tout
    (jpred, tpred) = seen
    np.testing.assert_array_equal(tpred, pred)
    assert pred.shape == (100,) and np.isfinite(pred).all()
    np.testing.assert_allclose(pred, jpred, rtol=1e-5, atol=0)


def test_predict_bnn_mc_matches_jax(files, monkeypatch, capsys, tmp_path):
    _float32(monkeypatch, "bnn")
    spec = tfam.FAMILIES["bnn"]
    data = read_json_dataset(str(files["dir"] / "ds.json"))
    ds = prepare_dataset(data, n_cases=spec.train.n_cases, c=spec.train.c,
                         nheads_pad=spec.nheads_pad)
    pre_path = str(tmp_path / "bnn_preproc.npz")
    save_preprocessing(ds, pre_path, nelem=100)
    jm, _, _ = jfam.build_family("bnn", ds.feat_dim, nelem=100,
                                 label_dim=ds.label_dim)
    params = jax.tree.map(np.asarray, jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "bayes": jax.random.PRNGKey(1),
         "diffusion": jax.random.PRNGKey(2)},
        jnp.zeros((1, spec.train.n_cases, ds.feat_dim))))()["params"])

    def normal_of(shape):
        return np.random.default_rng([*shape, 1]).normal(size=shape)

    def randint_of(shape):
        return np.random.default_rng([*shape, 2]).integers(0, 512, shape)

    monkeypatch.setattr(jax.random, "normal", lambda key, shape,
                        dtype=jnp.float32: jnp.asarray(normal_of(
                            tuple(shape)), dtype))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi,
                        *a, **k: jnp.asarray(randint_of(tuple(shape))))
    monkeypatch.setattr(tbayes, "_normal", lambda shape, generator, device,
                        dtype: torch.from_numpy(normal_of(tuple(shape)))
                        .to(dtype))
    monkeypatch.setattr(tbayes, "_randint", lambda high, shape, generator,
                        device: torch.from_numpy(randint_of(tuple(shape))))
    jout, tout, pred, _ = _predict_both(
        monkeypatch, capsys, tmp_path, "bnn", pre_path, params,
        bnn_params_from_flax, extra=("--mc-samples", "8"))
    rows = re.compile(r"^\s*(\d+) :\s*(\S+) : (\S+)$", re.M)
    jrows, trows = rows.findall(jout), rows.findall(tout)
    assert len(jrows) == len(trows) == 100
    jmean = np.array([float(m) for _, m, _ in jrows])
    np.testing.assert_allclose(pred, jmean, rtol=1e-5, atol=0)
    # eight equal samples: both stds are 0 up to the mean's rounding
    for got in (jrows, trows):
        std = np.array([float(s) for _, _, s in got])
        assert (std <= 1e-6 * np.abs(jmean)).all()


def test_bench_prints_three_lines_in_order(capsys):
    lines = bench.run(device="cpu", batch=4, chain=2, reps=1, iters=2,
                      baseline_iters=5, tfd_batch=8, tfd_steps=2,
                      tfd_epochs=2, baseline_steps=1)
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [x["metric"] for x in printed] == [
        "BeamOpt iters/sec", "surrogate samples/sec/chip",
        "batched beam FEA solves/sec"]
    assert [x["unit"] for x in printed] == ["iters/sec", "samples/sec",
                                            "solves/sec"]
    for x in printed:
        assert math.isfinite(x["value"]) and x["value"] > 0
        # rounded to 2 decimals: the plain versions at these sizes can
        # round to 0.0 against the CPU baseline
        assert math.isfinite(x["vs_baseline"]) and x["vs_baseline"] >= 0


@pytest.mark.parametrize("argv,message", [
    (["beam-opt"], "torch.cuda.is_available() is False"),
    (["datagen", "--mesh", *CPU], "--mesh is not supported"),
    (["frame-opt", "--mesh", *CPU], "--mesh is not supported"),
    (["train", "--model", "fnn", "--data", "x.json", "--shuffle-scope",
      "per_shard", *CPU], "per_shard is not supported"),
    (["train", "--model", "fnn", "--data", "x.json", "--mesh", *CPU],
     "--mesh is not supported"),
])
def test_refused(monkeypatch, argv, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code != 0 and message in str(e.value.code)


def test_module_entry():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "openpystruct_tpu_torch", "beam-opt",
         "--epochs", "3", "--refine", "0", *CPU],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Total Loss:" in out.stdout and "epochs=3" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "openpystruct_tpu_torch", "beam-opt",
         "--epochs", "3"], cwd=REPO, env=dict(env, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "is_available() is False" in out.stderr
