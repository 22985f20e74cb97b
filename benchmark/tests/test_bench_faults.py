"""A run driven past the look for a card, at a tiny size on the CPU, with
the timed path sound and with faults planted underneath it: ``correct``
holds for the sound path and falls for each fault the cell can have (a
train step that leaves its state unchanged, half of the batch left out,
an answer altered where it is produced) and for the control, the float8
reference in the program's place, under the cells' own limits."""

import dataclasses
import time

import pytest
import torch
import yaml

from benchmark.harness import cells, check, faults, spec

STREAM = "fusion_dinov3_vits16.stream_b1"
TRAIN = "fusion_dinov3_vits16.train_b12"
EVAL = "lidar_ptv3_parity.eval_b12"
SEED = 2 ** 32 + 17


@pytest.fixture
def one_layer_vit(monkeypatch):
    """A one-layer ViT-S on both sides: the full 12 layers take minutes on
    a CPU."""
    from benchmark.reference import widths
    import tpu3dssf_torch.models.vit as pv
    small = pv.dinov3_small
    monkeypatch.setattr(pv, "dinov3_small",
                        lambda: dataclasses.replace(small(), num_layers=1))
    full = widths.encoder
    monkeypatch.setattr(widths, "encoder", lambda name: dataclasses.replace(
        full(name), num_layers=1))
    monkeypatch.setattr(cells, "WARMUP_FRAMES", 1)


def tiny(name, tmp_path, **traffic):
    cell = spec.Cell(name, spec.benchmark())
    with open(cell.config_path) as f:
        raw = yaml.safe_load(f)
    raw["tpu_params"].update(point_capacity=4096, voxel_capacity=2048)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    cell.config_path = str(path)
    cell.traffic = dict(cell.traffic, valid_points=2800,
                        image_hw=[90, 160], **traffic)
    return cell


def run(cell, control=False):
    return cells.run(cell, SEED, 0.01, False, torch.device("cpu"),
                     time.perf_counter(), control=control)


def test_eval_sound_then_control(tmp_path):
    result, found, ctrl = run(tiny(EVAL, tmp_path, pool=4, batch=2,
                                   check_frames=1), control=True)
    assert result["correct"], result["checks"]
    limits = spec.Cell(EVAL, spec.benchmark()).limits
    assert any(ctrl[k] > limits[k] for k in ctrl), ctrl


@pytest.mark.parametrize("fault", ["half", "alter"])
def test_eval_fault(tmp_path, fault):
    with faults.plant(fault, "eval"):
        result, _, _ = run(tiny(EVAL, tmp_path, pool=4, batch=2,
                                check_frames=1))
    assert not result["correct"], result["checks"]


def test_stream_sound_then_control(tmp_path, one_layer_vit):
    result, found, ctrl = run(tiny(STREAM, tmp_path, pool=2,
                                   check_frames=1), control=True)
    assert result["correct"], result["checks"]
    limits = spec.Cell(STREAM, spec.benchmark()).limits
    assert any(ctrl[k] > limits[k] for k in ctrl), ctrl


def test_stream_answer_altered(tmp_path, one_layer_vit):
    with faults.plant("alter", "stream"):
        result, _, _ = run(tiny(STREAM, tmp_path, pool=2, check_frames=1))
    assert not result["correct"], result["checks"]


def test_train_sound_then_control(tmp_path, one_layer_vit):
    result, found, ctrl = run(tiny(TRAIN, tmp_path, pool=6, batch=2),
                              control=True)
    assert result["correct"], result["checks"]
    limits = spec.Cell(TRAIN, spec.benchmark()).limits
    assert any(ctrl[k] > limits[k] for k in ctrl), ctrl


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
def test_train_fault(tmp_path, one_layer_vit, fault):
    with faults.plant(fault, "train"):
        result, _, _ = run(tiny(TRAIN, tmp_path, pool=6, batch=2))
    assert not result["correct"], result["checks"]
    if fault == "unchanged":
        assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_sample_is_drawn_from_the_seed():
    frames = [(i % 3, i) for i in range(30)]
    picks = [check.sample(seed, frames, 4) for seed in range(20)]
    assert all(len({f[1] for f in p}) == 4 for p in picks)
    assert picks[3] == check.sample(3, frames, 4)
    assert len({tuple(f[1] for f in p) for p in picks}) > 10
    assert check.sample(5, frames[:2], 4) == frames[:2]
