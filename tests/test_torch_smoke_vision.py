"""chip_smoke.py's YOLOv3 and vision phases rehearsed on the CPU at small
sizes, the CPU standing in for the card: train_yolov3 and serve_yolov3 at
width 8, one residual block a stage, 64 x 64, 4 classes, B = 2; vision_ops
at a few elements an op. Each passes the port as it is, and each refuses a
fault planted in the card's runs only: nearest_interp reading the source
one pixel on (at exactly 2x the align_corners rule is a 2x repeat, so a
repeat is no fault there; tests/test_torch_vision_ops.py holds the rule
where they differ), and yolo_box without its clip to the image."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from test_torch_smoke_longtail import _card_fault  # noqa: E402

CPU = torch.device("cpu")
TINY_VI = dict(
    bilinear=(2, 3, 5, 11), nearest=(2, 3, 4, 8), trilinear=(1, 2, 3, 5),
    pool3d=(2, 3, 4, 6), conv3d=(1, 3, 4, 5, 4), adaptive2d=(2, 6, 4),
    pixel=(2, 8, 3, 2), shuffle=(2, 6, 3, 2), tsm=(8, 8, 3, 4),
    maxout=(2, 6, 3, 2), lrn=(2, 7, 4), affine=(2, 3, 4, 5),
    multiplex=(3, 6, 5), crop=(1, 3, 9, 5), padlike=(2, 3, 4),
    unfold=(2, 3, 5), grid=(2, 3, 5), btp=(6, 4, 3), shard=(20, 100, 4),
    im2seq=(2, 3, 4, 5), conv3dt=(1, 3, 3, 2), adaptive3d=(2, 4, 2, 3),
    deform=(1, 4, 5, 6), ssd=(2, 5, 3), ssd_scale=4,
    roi_align=(2, 3, 20, 24, 6, 3), roi_pool=(2, 3, 8, 9, 6, 2),
    yolo=(2, 4, 3, 5), anchor=(1, 4, 3, 5), density=(1, 4, 4, 64),
    proposals=(1, 4, 5, 40, 12), psroi=(1, 2, 2, 8, 9, 5),
    sampling=(6000, 5), random_crop=(40, 2, 8, 5))


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "VI_DIMS", TINY_VI)
    for name, value in (("YOLO_HW", 64), ("YOLO_WIDTH", 8),
                        ("YOLO_STAGES", (1, 1, 1, 1, 1)), ("YOLO_CLASSES", 4),
                        ("YOLO_HOLD_B", 2), ("YOLO_B", 2), ("YOLO_STEPS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)


def _nearest_one_pixel_on(plain):
    """The nearest resize's source one pixel on (clipped at the edge)."""
    def compute(ctx):
        x = ctx.input("X")
        out = plain(ctx)["Out"]
        shifted = torch.cat([x[:, :, 1:], x[:, :, -1:]], 2)
        shifted = torch.cat([shifted[:, :, :, 1:], shifted[:, :, :, -1:]], 3)
        ratio = out.shape[2] // x.shape[2]
        return {"Out": shifted.repeat_interleave(ratio, 2).repeat_interleave(
            ratio, 3)}
    return compute


def _yolo_box_unclipped(plain):
    def compute(ctx):
        out = plain(ctx)
        return dict(out, Boxes=out["Boxes"] * 1.5 - 4.0)
    return compute


def test_train_yolov3_phase_holds_the_port(tiny, capsys):
    assert chip_smoke.train_yolov3(CPU, "CPU") == ({}, {})
    out = capsys.readouterr().out
    assert "YOLOv3 (DarkNet-53, 64x64, 4 classes) step 1 at B=2" in out
    assert "images/s" in out and "ignore decisions" in out


def test_train_yolov3_phase_refuses_a_shifted_upsample(tiny, monkeypatch):
    _card_fault(monkeypatch, "nearest_interp", _nearest_one_pixel_on)
    with pytest.raises(RuntimeError, match="YOLOv3 step 1: "):
        chip_smoke.train_yolov3(CPU, "CPU")


def test_serve_yolov3_phase_holds_the_port(tiny, capsys):
    counts, _ = chip_smoke.serve_yolov3(CPU, "CPU")
    assert counts == {}
    out = capsys.readouterr().out
    assert "the NMS rows bit for bit the CPU op's" in out and "detections" in out


def test_serve_yolov3_phase_refuses_unclipped_boxes(tiny, monkeypatch):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import executor

    _card_fault(monkeypatch, "yolo_box", _yolo_box_unclipped)
    # the predictor makes its executor from the executor module
    monkeypatch.setattr(executor, "Executor", pt.Executor)
    with pytest.raises(RuntimeError, match="the boxes on the card are"):
        chip_smoke.serve_yolov3(CPU, "CPU")


def test_vision_ops_phase_holds_the_port(tiny, capsys):
    chip_smoke.vision_ops(CPU, "CPU")
    out = capsys.readouterr().out
    assert "vision and detection ops on the card against the CPU (40 cases" in out


def test_vision_ops_phase_refuses_a_shifted_upsample(tiny, monkeypatch):
    _card_fault(monkeypatch, "nearest_interp", _nearest_one_pixel_on)
    with pytest.raises(RuntimeError, match="nearest_interp: o on the card"):
        chip_smoke.vision_ops(CPU, "CPU")
