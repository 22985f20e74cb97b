"""The port's ``cli/parity_ab.py`` and LiDAR-only training vs the JAX
package's, on the CPU at a tiny size.

One module fixture runs ``scripts/parity_ab.run`` (the JAX script, its
plain path on the CPU: no Pallas) on the pipeline tests' tiny config as a
LiDAR-only model (full-width PTv3 at capacity 512, f32, 4 frames at batch
2, random init), converts its initial params to the port with
``convert.py``, saves them as a port checkpoint and runs the port's
``parity_ab.run`` on it. Both sides' logits of every variant and batch are
recorded. Tolerances:

- logits: within ``LOGIT_TOL`` of the largest |logit| (f32 sums over
  22 full-width blocks in another order: ~3e-4 of that scale at most);
- predictions: equal per variant and valid point, except where JAX's two
  largest logits lie within ``LOGIT_TOL`` of the largest |logit| of the
  batch; such flips are counted and at most ``MAX_FLIPS`` of the valid
  points;
- per-frame agreement and accuracy, and the rows' means, CIs and minima:
  within 1e-6, plus the share of the frame's points that flipped (each
  flip moves a frame's share by one point);
- the port's per-frame values against the JAX script's formulas applied to
  the port's own logits: within 1e-12 (the same arithmetic on the same
  predictions).

The 3-step trajectory (f32, AdamW + cosine + clip, the convergence
configs' recipe) holds each step's loss within 1e-5 relative and every
parameter after step 3 within 1e-4 of its largest magnitude, as
``tests/test_torch_train.py`` holds one step (the qkv key biases aside,
for its reason).
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_convert import port_pipeline_config, t, to_numpy_tree
from tests.test_torch_lidar import _lattice_points, _small_ptv3
from tests.test_torch_lidar import _tiny_lidar_config
from tests.test_torch_train import OPT_KW, _assert_rel
from tpu3dssf import losses as jlosses
from tpu3dssf.cli import common as jcommon
from tpu3dssf.models import fusion as jfusion
from tpu3dssf.models import lidar_only as jlidar
from tpu3dssf.train import loop as jloop
from tpu3dssf.train import state as jstate
from tpu3dssf_torch import convert, losses
from tpu3dssf_torch.cli import common, parity_ab
from tpu3dssf_torch.models import lidar_only
from tpu3dssf_torch.train import TrainState, create_optimizer, make_train_step
from tpu3dssf_torch.train.checkpoint import save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, BATCH = 4, 2
LOGIT_TOL = 1e-3        # |Δ logit| and, at a flip, JAX's top-2 gap,
                        # over max |logit|
MAX_FLIPS = 0.005       # flips over the valid points of a variant
FRAME_TOL = 1e-6
LOSS_TOL = 1e-5         # per step, relative
PARAM_TOL = 1e-4        # after step 3, relative to max |param|


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "parity_ab_script", os.path.join(ROOT, "scripts", "parity_ab.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _variant(modes):
    return next(k for k, v in parity_ab.VARIANTS.items() if v == modes)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """JAX's ``run`` and the port's on the same weights and frames:
    {"jax" | "port": (result, {variant: [logits per batch]})}, the config
    and the port checkpoint."""
    tmp = tmp_path_factory.mktemp("parity_ab")
    path = _tiny_lidar_config(tmp)
    script = _jax_script()
    jlogits = {name: [] for name in parity_ab.VARIANTS}
    states = []
    jit = jax.jit

    def recording_jit(fn, *a, **kw):
        jitted = jit(fn, *a, **kw)
        owner = getattr(fn, "__self__", None)
        if getattr(fn, "__name__", "") != "apply" or not isinstance(
                owner, jlidar.LidarSegmentationModel):
            return jitted
        name = _variant((owner.config.intensity_mode,
                         owner.config.devoxelize_mode))

        def call(*args):
            out = jitted(*args)
            jlogits[name].append(np.asarray(out))
            return out
        return call

    def recording_init_state(*a, **kw):
        states.append(init_state(*a, **kw))
        return states[-1]

    init_state = jcommon.init_state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", recording_jit)
        mp.setattr(jcommon, "init_state", recording_init_state)
        jres = script.run(path, None, FRAMES, BATCH)

    cfg = common.load_config(path)
    model, _ = common.build_pipeline(cfg, None, "cpu")
    model.load_state_dict(convert.pipeline_state_dict_from_flax(
        to_numpy_tree(states[0].params)))
    ckpt = str(tmp / "port_ckpt")
    save_checkpoint(ckpt, 0, common.init_state(cfg, model))

    plogits = {name: [] for name in parity_ab.VARIANTS}

    def recording_graphed(step, name):
        variant = name.split(" ", 1)[1]

        def call(*args):
            out = step(*args)
            plogits[variant].append(out.float().numpy())
            return out
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parity_ab, "graphed", recording_graphed)
        pres = parity_ab.run(path, ckpt, FRAMES, BATCH, device="cpu")
    return dict(jax=(jres, jlogits), port=(pres, plogits), config=path,
                ckpt=ckpt, tmp=tmp)


def _stream_batches(path):
    """The JAX script's frame stream, rebuilt from the JAX package."""
    from tpu3dssf.config import load_config
    from tpu3dssf.data import HostDataPipeline, SyntheticNuScenes
    cfg = load_config(path)
    ds = SyntheticNuScenes(
        num_samples=FRAMES, seed=7, num_points=cfg.tpu.synthetic_points,
        image_hw=tuple(cfg.tpu.synthetic_image_hw),
        render_semantics=cfg.tpu.synthetic_render, cache=False)
    return list(HostDataPipeline(ds, batch_size=BATCH,
                                 point_capacity=cfg.tpu.point_capacity))


def _per_frame(batches, logits):
    """The JAX script's per-frame agreement with full-parity and accuracy
    from recorded logits; with the valid mask of each frame."""
    agree = {"default": [], "devox-parity": []}
    acc = {name: [] for name in parity_ab.VARIANTS}
    masks = []
    for bi, batch in enumerate(batches):
        preds = {n: logits[n][bi].argmax(-1) for n in parity_ab.VARIANTS}
        valid = batch["point_valid"] & (batch["labels"] != 0)
        labels = batch["labels"] - 1
        for b in range(valid.shape[0]):
            m = valid[b]
            masks.append((bi, b, m))
            ref = preds["full-parity"][b][m]
            for name in parity_ab.VARIANTS:
                p = preds[name][b][m]
                acc[name].append(float((p == labels[b][m]).mean()))
                if name in agree:
                    agree[name].append(float((p == ref).mean()))
    return agree, acc, masks


def _flips(both):
    """{variant: [flipped valid points per frame]}; asserts every flip is
    at a near-tie of JAX's logits and bounds their number."""
    batches = _stream_batches(both["config"])
    jlogits, plogits = both["jax"][1], both["port"][1]
    _, _, masks = _per_frame(batches, jlogits)
    out = {}
    for name in parity_ab.VARIANTS:
        assert len(jlogits[name]) == len(plogits[name]) == len(batches)
        per_frame, total, n_valid = [], 0, 0
        for bi, b, m in masks:
            jl, pl = jlogits[name][bi][b][m], plogits[name][bi][b][m]
            flip = jl.argmax(-1) != pl.argmax(-1)
            top2 = np.sort(jl[flip], -1)[:, -2:]
            gap = (top2[:, 1] - top2[:, 0]) / np.abs(jlogits[name][bi]).max()
            assert (gap <= LOGIT_TOL).all(), (name, gap.max())
            per_frame.append(int(flip.sum()))
            total, n_valid = total + int(flip.sum()), n_valid + int(m.sum())
        assert total <= MAX_FLIPS * n_valid, (name, total, n_valid)
        out[name] = per_frame
    return out, masks


def test_parity_ab_predictions_match_jax_but_near_ties(both):
    flips, masks = _flips(both)
    for name in parity_ab.VARIANTS:
        n = sum(flips[name])
        print(f"{name}: {n} near-tie flips over "
              f"{sum(int(m.sum()) for *_, m in masks)} valid points")
    for name in parity_ab.VARIANTS:
        for jl, pl in zip(both["jax"][1][name], both["port"][1][name]):
            _assert_rel(pl, jl, LOGIT_TOL, what=f"{name} logits")


def test_parity_ab_per_frame_and_rows_match_jax(both):
    jres, jlogits = both["jax"]
    pres, plogits = both["port"]
    batches = _stream_batches(both["config"])
    flips, masks = _flips(both)
    j_agree, j_acc, _ = _per_frame(batches, jlogits)
    p_agree, p_acc, _ = _per_frame(batches, plogits)
    # the port's bookkeeping is the script's on its own predictions
    for name in parity_ab.VARIANTS:
        np.testing.assert_allclose(pres["acc_frames"][name], p_acc[name],
                                   rtol=0, atol=1e-12)
    for name in j_agree:
        np.testing.assert_allclose(pres["agree_frames"][name],
                                   p_agree[name], rtol=0, atol=1e-12)
    assert pres["frames"] == jres["frames"] == FRAMES
    assert pres["batch_size"] == jres["batch_size"] == BATCH
    # against JAX per frame: 1e-6 plus the flipped share of the frame
    n_frame = np.array([int(m.sum()) for *_, m in masks])
    worst = np.zeros(FRAMES)
    for name in parity_ab.VARIANTS:
        share = np.array(flips[name]) / n_frame
        ref = np.array(flips["full-parity"]) / n_frame
        worst = np.maximum(worst, share + ref)
        np.testing.assert_array_less(
            np.abs(np.array(pres["acc_frames"][name]) - j_acc[name]),
            FRAME_TOL + share + 1e-12)
        if name in j_agree:
            np.testing.assert_array_less(
                np.abs(np.array(pres["agree_frames"][name])
                       - j_agree[name]), FRAME_TOL + share + ref + 1e-12)
    # the rows: means, CIs (1.96 σ/√N moves by at most twice the largest
    # per-frame move) and minima
    tol = FRAME_TOL + 2 * worst.max() + 1e-12
    for pr, jr in zip(pres["rows"], jres["rows"]):
        assert pr["variant"] == jr["variant"]
        for k in ("agree_mean", "agree_ci", "agree_min", "acc_mean",
                  "acc_ci"):
            assert abs(pr[k] - jr[k]) <= tol, (pr["variant"], k)
    for a, b in zip(pres["acc_full"], jres["acc_full"]):
        assert abs(a - b) <= tol
    # per class: counts of the full-parity predictions and labels
    for pc, jc in zip(pres["per_class"], jres["per_class"]):
        assert pc["cls"] == jc["cls"]
        assert abs(pc["ref_n"] - jc["ref_n"]) <= sum(flips["full-parity"])
    # every variant ran once per batch on the CPU: no kernel launched
    assert pres["batches"] == FRAMES // BATCH
    assert all(not v for v in pres["launches"].values())


def _without_block(text, opening):
    """``text`` less the paragraph that starts with the line ``opening``
    (up to its blank line)."""
    lines, out, skip = text.split("\n"), [], False
    for line in lines:
        if line.startswith(opening):
            skip = True
        elif skip and not line:
            skip = False
            continue
        if not skip:
            out.append(line)
    return "\n".join(out)


def test_report_is_the_jax_scripts_markdown(both, tmp_path, monkeypatch):
    """The port's ``report`` against the JAX script's ``main`` (its
    ``run`` replaced by the port's results): the same file, byte for
    byte, for one checkpoint and for two, less the conclusion under the
    two-checkpoint table (the script's is a fixed text of its own run, the
    port's is computed: :func:`test_conclusion_is_computed_from_the_table`),
    and the same ``section`` of one result."""
    pres = both["port"][0]
    script = _jax_script()
    for labels in (["trained"], ["a-trained", "b-trained"]):
        monkeypatch.setattr(script, "run", lambda *a: pres)
        out = tmp_path / f"jax_{len(labels)}.md"
        argv = ["parity_ab.py", "--out", str(out)]
        for lbl in labels:
            argv += ["--checkpoint", f"{lbl}=x" if len(labels) > 1 else "x"]
        monkeypatch.setattr(sys, "argv", argv)
        script.main()
        port = "\n".join(parity_ab.report(
            [(lbl, pres) for lbl in labels])) + "\n"
        jax_text = _without_block(out.read_text(), "**Conclusion")
        assert _without_block(port, "**Measured") == jax_text
        assert ("**Conclusion" in out.read_text()) == (len(labels) > 1)
        assert ("**Measured" in port) == (len(labels) > 1)
    assert parity_ab.section("x", pres) == script.section("x", pres)


def _result(acc, agree):
    """A result dict whose table cells are ``acc`` (default, devox-parity,
    full-parity) with 95% half-widths of 0.01."""
    return {"rows": [{"variant": v, "acc_mean": a, "acc_ci": 0.01,
                      "agree_mean": g}
                     for v, a, g in zip(("default", "devox-parity"), acc,
                                        agree)],
            "acc_full": (acc[2], 0.01)}


@pytest.mark.parametrize("table, dominates", [
    # the TPU's PARITY_AB.md: each checkpoint best in its own modes
    ({"default-trained": ((0.7342, 0.6468, 0.6470), (0.72, 0.9863)),
      "parity-trained": ((0.6358, 0.7149, 0.7150), (0.70, 0.9915))}, True),
    # rows that barely change with the eval modes
    ({"default-trained": ((0.7281, 0.7281, 0.7282), (0.72, 0.9900)),
      "parity-trained": ((0.7289, 0.7289, 0.7291), (0.72, 0.9903))}, False),
])
def test_conclusion_is_computed_from_the_table(table, dominates):
    results = [(lbl, _result(acc, (agree, devox)))
               for lbl, (acc, (agree, devox)) in table.items()]
    lines = parity_ab.conclusion(results)
    text = "\n".join(lines)
    assert f"dominates its rows and columns: " \
        f"{'yes' if dominates else 'no'}." in text
    devox = [d for _, (_, (_, d)) in table.items()]
    assert f"reproduces {100 * min(devox):.2f}% to {100 * max(devox):.2f}%" \
        in text
    for lbl, (acc, _) in table.items():
        best = ("default", "devox-parity", "full-parity")[
            int(np.argmax(acc))]
        assert f"- {lbl}: best under {best} ({max(acc):.4f})" in text


def test_default_out_is_never_the_repos_parity_ab(both, capsys):
    ap = parity_ab.checkpoints
    assert parity_ab.default_out(both["config"], ap([both["ckpt"]])) == \
        os.path.join(both["ckpt"], "parity_ab.md")
    stock = os.path.join(ROOT, "configs/synthetic_convergence_lidar.yaml")
    for given in (None, ["a=/x/a", "b=/x/b"]):
        out = parity_ab.default_out(stock, ap(given))
        assert os.path.basename(out) != "PARITY_AB.md"
        assert os.path.abspath(out) != os.path.join(ROOT, "PARITY_AB.md")
    with open(os.path.join(ROOT, "PARITY_AB.md"), "rb") as f:
        before = f.read()
    results = parity_ab.main(["--config", both["config"], "--checkpoint",
                              both["ckpt"], "--frames", "2", "--device",
                              "cpu"])
    assert results[0][1]["trained"] and results[0][1]["frames"] == 2
    assert os.path.exists(os.path.join(both["ckpt"], "parity_ab.md"))
    with open(os.path.join(ROOT, "PARITY_AB.md"), "rb") as f:
        assert f.read() == before
    assert "wrote " + os.path.join(both["ckpt"], "parity_ab.md") in \
        capsys.readouterr().out


def test_main_train_passes_its_seed_to_the_model(both, monkeypatch):
    """``main_train.main(argv, seed=s)`` draws the model from ``s`` (the
    convergence runs' second seed), by default from the CLI's 1."""
    from tpu3dssf_torch.cli import main_train

    class Drawn(Exception):
        pass

    def build(cfg, vit_cfg, device, seed=None):
        raise Drawn(seed)

    monkeypatch.setattr(common, "build_pipeline", build)
    for kw, want in (({}, 1), ({"seed": 2}, 2)):
        with pytest.raises(Drawn) as drawn:
            main_train.main(["--config", both["config"], "--device", "cpu"],
                            **kw)
        assert drawn.value.args == (want,)


def test_cli_refuses_to_fall_back_to_cpu(both):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity_ab.main(["--config", both["config"], "--checkpoint",
                        both["ckpt"], "--out", str(both["tmp"] / "x.md")])


def test_variants_share_the_restored_weights(both):
    cfg = common.load_config(both["config"])
    models, step = parity_ab.load_variants(cfg, None, both["ckpt"], "cpu")
    assert step == 0 and list(models) == list(parity_ab.VARIANTS)
    ref = models["full-parity"].state_dict()
    for name, m in models.items():
        assert (m.config.intensity_mode, m.config.devoxelize_mode) == \
            parity_ab.VARIANTS[name]
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
            assert v.data_ptr() != ref[k].data_ptr() or m is \
                models["full-parity"]


def test_lidar_training_trajectory_matches_jax(rng, monkeypatch):
    """3 AdamW + cosine + clip steps of a small LiDAR-only model in the
    parity modes (knn5, nearest) at f32 from one converted init: each
    step's loss, and every parameter after the third."""
    _lidar_trajectory(rng, monkeypatch, OPT_KW)


# SGD with Nesterov momentum under the plateau and the non-finite guard:
# the settings that kept the port's train step eager before they became
# device state (one step an epoch, so the plateau decides every step)
SGD_PLATEAU_KW = dict(name="SGD", learning_rate=0.05, momentum=0.9,
                      nesterov=True, lr_scheduler="ReduceLROnPlateau",
                      steps_per_epoch=1, num_epochs=20, grad_clip=1.0,
                      skip_nonfinite=True)


def test_lidar_training_trajectory_with_sgd_plateau_skip_matches_jax(
        rng, monkeypatch):
    """The same 3-step trajectory under SGD (Nesterov), ReduceLROnPlateau
    and skip_nonfinite, at the same tolerances."""
    _lidar_trajectory(rng, monkeypatch, SGD_PLATEAU_KW)


def _lidar_trajectory(rng, monkeypatch, opt_kw):
    monkeypatch.setattr(jlosses, "lovasz_softmax", functools.partial(
        jlosses.lovasz_softmax, exact_sort=True))
    pcfg = jfusion.PipelineConfig(
        fusion=jfusion.FusionConfig(output_dim=16), ptv3=_small_ptv3(),
        voxel_size=0.5, voxel_capacity=512, intensity_mode="knn5",
        devoxelize_mode="nearest")
    pts, mask = _lattice_points(rng)
    labels = rng.integers(0, 17, size=mask.shape).astype(np.int32)
    batch = dict(points=pts, point_valid=mask, labels=labels,
                 mask=mask & (labels != 0),
                 cam_intrinsics=np.zeros((2, 6, 3, 3), np.float32),
                 lidar2cam=np.zeros((2, 6, 4, 4), np.float32))
    tokens = np.zeros((2, 1, 1, 1), np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jlidar.LidarSegmentationModel(pcfg)
    params = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(5), jb["points"], jb["point_valid"]))
    kw = dict(opt_kw)
    jst = jstate.create_train_state(jmodel, params, jstate.create_optimizer(
        kw.pop("name"), **kw))
    jstep = jloop.make_train_step(jlosses.CELSLoss(
        weight=np.ones(16, np.float32)))

    model = lidar_only.LidarSegmentationModel(port_pipeline_config(pcfg))
    model.load_state_dict(convert.pipeline_state_dict_from_flax(params))
    kw = dict(opt_kw)
    state = TrainState(model, create_optimizer(model.parameters(),
                                               kw.pop("name"), **kw))
    step = make_train_step(losses.CELSLoss(weight=np.ones(16)))
    tb = {k: t(v) for k, v in batch.items()}
    for i in range(3):
        jst, jm = jstep(jst, jb, jnp.asarray(tokens))
        m = step(state, tb, t(tokens))
        _assert_rel(m["loss"].numpy(), np.asarray(jm["loss"]), LOSS_TOL,
                    what=f"loss of step {i}")
        assert int(m["correct"]) == int(jm["correct"])
        assert int(m["valid"]) == int(jm["valid"])
    assert state.step == 3
    jp = convert.pipeline_state_dict_from_flax(to_numpy_tree(jst.params))
    for k, p in model.state_dict().items():
        got, want = p.numpy(), jp[k].numpy()
        if k.endswith("attn.qkv.bias"):
            # the key bias's gradient is 0 in exact arithmetic (softmax
            # ignores a per-row constant) and rounding noise in both
            # frameworks, which Adam turns into O(lr) updates of either
            # sign: compared without its key third, as in one step
            C = got.shape[0] // 3
            got, want = (np.delete(x, np.s_[C:2 * C]) for x in (got, want))
        _assert_rel(got, want, PARAM_TOL, what=f"param {k} after 3 steps")
    moved = max(float(np.abs(jp[k].numpy() - v.numpy()).max()) for k, v in
                convert.pipeline_state_dict_from_flax(params).items())
    assert moved > 1e-4          # the steps moved the weights


def test_config_copies_keep_the_committed_records(tmp_path):
    """The convergence script trains on copies whose checkpoint paths
    point into its work directory, never at the committed TPU records."""
    from tpu3dssf_torch.cli import convergence
    for name, (src, record, _) in convergence.CONFIGS.items():
        path, ckpt = common.config_copy(os.path.join(ROOT, src),
                                        str(tmp_path / name), "config.yaml")
        with open(path) as f:
            raw = yaml.safe_load(f)
        assert raw["train_params"]["checkpoint_path"] == ckpt
        assert raw["train_params"]["best_model_path"] == ckpt
        assert raw["test_params"]["checkpoint_path"] == ckpt
        assert raw["train_params"]["max_num_epochs"] == 30
        assert ckpt.startswith(str(tmp_path))
        history = convergence.tpu_history(record)
        assert len(history["epochs"]) == 30
    cmp = convergence.compare(
        {1: {"best_val_acc": 0.5, "epochs": [
            {"train_loss": 2.0, "overall_acc": 0.5, "mean_iou": 0.1}]}},
        {"best_val_acc": 0.51, "epochs": [
            {"train_loss": 2.0, "overall_acc": 0.51, "mean_iou": 0.1}]})
    assert cmp["within_limit"] == {1: True}
    assert convergence.first_parting([[0.5, 0.6], [0.52, 0.6]],
                                     [0.51, 0.7]) == 1


@pytest.mark.parametrize("src", ["configs/synthetic_convergence_lidar_parity"
                                 ".yaml",
                                 "configs/synthetic_convergence_lidar.yaml"])
def test_chip_smoke_derives_the_lidar_launches(src):
    """chip_smoke's launches of the LiDAR-only model, derived from the
    model (phases 27-28), against a count of its blocks by stage: a
    forward with LSE and a backward per block (K2/K3 at C = 128...512,
    K4/K5 at C = 32, 64), one K1 per block in eval, one K7 per k-NN mode;
    and against a count of the LayerNorm modules of the model built from
    the same config: one LN each, and one LNB each in a train step."""
    import chip_smoke as cs
    from tpu3dssf_torch.models.layers import LayerNorm
    from tpu3dssf_torch.models.ptv3 import PointTransformerV3, PTv3Config

    cfg = common.load_config(os.path.join(ROOT, src))
    p = PTv3Config()
    channels = list(zip(p.enc_channels, p.enc_depths)) + list(
        zip(p.dec_channels, p.dec_depths))
    big = sum(d for c, d in channels if c % 128 == 0)
    small = sum(d for c, d in channels if c % 128)
    with torch.device("meta"):
        norms = sum(isinstance(m, LayerNorm)
                    for m in PointTransformerV3(p).modules())
    k7 = int(cfg.tpu.intensity_mode == "knn5") + int(
        cfg.tpu.devoxelize_mode == "nearest")
    step, batch = cs.lidar_launches(cfg)
    want = {"K2": big, "K3": big, "K4": small, "K5": small, "K7": k7,
            "LN": norms, "LNB": norms}
    assert step == {k: v for k, v in want.items() if v}
    assert batch == {k: v for k, v in (("K1", big + small), ("K7", k7),
                                       ("LN", norms)) if v}
    assert (big, small, norms) == (14, 8, cs.PTV3_NORMS)
    per_variant = {"default": {"K1": 22, "LN": norms},
                   "devox-parity": {"K1": 22, "K7": 1, "LN": norms},
                   "full-parity": {"K1": 22, "K7": 2, "LN": norms}}
    for name, modes in parity_ab.VARIANTS.items():
        assert cs.lidar_launches(cfg, *modes)[1] == per_variant[name]


def _lovasz_unguarded(probs, labels0, valid):
    """JAX's ``lovasz_softmax`` on its 13-bit packed sort key with no bound
    on N: the loss the TPU's convergence records ran (their
    ``training_history.json`` files were written before the key's payload
    was bounded to N ≤ 2**17, past which ``tpu3dssf/losses.py`` now sorts
    exactly)."""
    N, C = probs.shape
    fg = jnp.where(valid[None, :],
                   labels0[None, :] == jnp.arange(C)[:, None], False)
    errors = jnp.where(valid[None, :], jnp.abs(fg.astype(jnp.float32)
                                               - probs.T), 0.0)
    packed = (jnp.arange(N, dtype=jnp.int32) * 2)[None, :] + \
        fg.astype(jnp.int32)
    q = (8191.0 - jnp.round(errors * 8191.0)).astype(jnp.int32)
    vs = jax.vmap(lambda x: jax.lax.sort((x,), num_keys=1)[0])(
        (q << 18) | packed)
    packed_s = vs & 0x3FFFF
    fg_s = (packed_s & 1).astype(jnp.float32)
    gts = jnp.sum(fg_s, axis=1, keepdims=True)
    cfg = jnp.cumsum(fg_s, axis=1)
    union = gts + (jnp.arange(1, N + 1, dtype=jnp.float32)[None, :] - cfg)
    jaccard = 1.0 - (gts - cfg) / jnp.maximum(union, 1e-12)
    grad = jnp.concatenate(
        [jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], axis=1)
    grad_u = jax.vmap(lambda k, g: jax.lax.sort((k, g), num_keys=1)[1])(
        packed_s, grad)
    present = (gts[:, 0] > 0).astype(jnp.float32)
    return jnp.sum(jnp.sum(errors * grad_u, axis=1) * present) / \
        jnp.maximum(jnp.sum(present), 1.0)


def test_lovasz_at_batch_4_is_exact_not_the_records_packed_key(rng):
    """The LiDAR configs' flattened batch (4 × 34,816 = 139,264 > 2**17):
    the port's Lovász equals JAX's, which sorts exactly there (within
    1e-5); the packed key the TPU's records ran, replicated here and equal
    to JAX's packed path at 2 × 34,816 (within 1e-6), loses its payload's
    top bit at 4 × 34,816 and gives another loss (by more than 0.3)."""
    for batch in (2, 4):
        N, C = batch * 34816, 16
        labels0 = rng.integers(0, C, N)
        logits = rng.normal(size=(N, C)).astype(np.float32)
        logits[np.arange(N), labels0] += np.where(rng.random(N) < 0.6, 3, 0)
        probs = jax.nn.softmax(jnp.asarray(logits), -1)
        valid = rng.random(N) < 0.98
        args = (probs, jnp.asarray(labels0), jnp.asarray(valid))
        jax_loss = float(jax.jit(jlosses.lovasz_softmax)(*args))
        packed = float(jax.jit(_lovasz_unguarded)(*args))
        port = float(losses.lovasz_softmax(
            torch.from_numpy(np.array(probs)), torch.from_numpy(labels0),
            torch.from_numpy(valid)))
        print(f"batch {batch}: Lovász port {port:.6f}, JAX {jax_loss:.6f}, "
              f"unbounded packed key {packed:.6f}")
        assert abs(port - jax_loss) <= 1e-5
        if batch == 2:
            assert abs(packed - jax_loss) <= 1e-6
        else:
            assert jax_loss - packed > 0.3


class _RuleModel(torch.nn.Module):
    """Parameters named as PTv3's (``...attn.qkv.bias``) in a model small
    enough for many steps on a loaded CPU."""

    def __init__(self):
        super().__init__()
        self.attn = torch.nn.Module()
        self.attn.qkv = torch.nn.Linear(4, 12)
        self.head = torch.nn.Linear(12, 3)

    def forward(self, x):
        return self.head(torch.tanh(self.attn.qkv(x)))


def _rule_step(state, x):
    """One AdamW + cosine + clip update on a squared loss, as
    ``make_train_step`` drives the optimizer."""
    state.optimizer.zero_grad()
    state.model(x).square().mean().backward()
    state.apply_gradients()


def test_chip_smoke_graph_rule_holds_every_parameter(rng):
    """chip_smoke's rule for graphed train steps (phases 23, 27 and 29:
    bit for bit), on the CPU on a small model with the eager step in the
    graphed one's place: the same runs pass (every difference 0), and two
    faulty "graphed" steps fail it: one that moves a weight by 1e-3 after
    its update, and one that moves the key third of a qkv bias by 1e-6."""
    import chip_smoke as cs

    names = ["blk.attn.qkv.bias", "blk.attn.qkv.weight"]
    bias, weight = torch.arange(6.0), torch.ones(2, 3)
    rest, keys = cs.split_key_bias(names, [bias, weight])
    assert [r.tolist() for r in rest] == [[0, 1, 4, 5], [1.0] * 6]
    assert [k.tolist() for k in keys] == [[2, 3]]
    with pytest.raises(ValueError):
        cs.eager_rule([[bias]] * cs.GRAPH_RUNS, [[bias]] * cs.GRAPH_RUNS)

    torch.manual_seed(0)
    model = _RuleModel()
    kw = dict(OPT_KW)
    state = TrainState(model, create_optimizer(model.parameters(),
                                               kw.pop("name"), **kw))
    step, args = _rule_step, (torch.as_tensor(rng.normal(size=(8, 4)),
                                              dtype=torch.float32),)
    step(state, *args)
    row = cs.hold_train_runs("cpu", state, step, step, args)
    assert row["params_diff"] == [0.0, 0.0]
    assert row["key_bias_diff"] == [0.0, 0.0]
    [(updates, trace)] = row["counts"]
    assert updates == 1 + cs.GRAPH_TRAIN_STEPS
    assert [c["count"] for c in trace] == list(
        range(2, 2 + cs.GRAPH_TRAIN_STEPS))

    params = dict(state.model.named_parameters())
    qkv = "attn.qkv.bias"
    C = params[qkv].numel() // 3

    def faulty(name, part, by):
        def run(st, *a):
            step(st, *a)
            with torch.no_grad():
                params[name].view(-1)[part] += by
        return run

    for name, part, by in (("head.weight", 0, 1e-3),
                           (qkv, slice(C, 2 * C), 1e-6)):
        with pytest.raises(AssertionError, match="graphed steps off"):
            cs.hold_train_runs("cpu", state, faulty(name, part, by), step,
                               args)
