"""chip_smoke.py's four phases of the rest of serving (serve_resilience,
serve_control, serve_fleet, serve_disagg) rehearsed on the CPU at
decoder_tiny's widths: each passes the port, and each refuses a planted
fault its gates exist for — a pool rebuild that rebuilds nothing, a
router that delivers replayed tokens twice, a handoff commit that drops
the lease's pin instead of moving it."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu_torch.executor as executor  # noqa: E402
from paddle_tpu_torch.serving import FleetRouter, PagedKVPool  # noqa: E402

SERVE_TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
                  ffn_size=64, max_position=64)
CPU = torch.device("cpu")


@pytest.fixture
def rehearsal(monkeypatch):
    """The phases on the CPU: device calls made no-ops, the executor's
    default device the CPU, the widths decoder_tiny's, the launch check
    stubbed (the CPU runs the plain versions), the heartbeat and the lease
    TTL shortened; returns (base engine, prompts, its tokens)."""
    for fn in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    resolve = executor.resolve_device
    monkeypatch.setattr(executor, "resolve_device", lambda d=None: CPU
                        if d is None else resolve(d))
    for name, value in (("SERVE_CFG", SERVE_TINY),
                        ("SERVE_LENS", (3, 9, 17, 20)), ("SERVE_NEW", 6),
                        ("FLEET_HEARTBEAT_S", 0.3), ("DISAGG_TTL_S", 0.3)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "_check_serving_launches",
                        lambda *a: None)
    from paddle_tpu_torch.serving import ServingEngine

    base = ServingEngine(chip_smoke._serve_cfg(), device=CPU,
                         seed=chip_smoke.SEED)
    prompts = chip_smoke._serve_prompts(base.cfg, chip_smoke.SEED,
                                        chip_smoke.SERVE_LENS)
    rids, wall = chip_smoke._drive(base, prompts)
    base.first_pass = chip_smoke._report("rehearsal", base, rids, wall, "CPU")
    outs = [base.result(r) for r in rids]
    chip_smoke._hold_exact("rehearsal", base, prompts, outs)
    return base, prompts, outs


@pytest.mark.parametrize("phase", ["serve_resilience", "serve_control",
                                   "serve_fleet", "serve_disagg"])
def test_phase_passes_the_port(rehearsal, phase, capsys):
    base, prompts, outs = rehearsal
    counts = getattr(chip_smoke, phase)(CPU, "CPU", base, prompts, outs)
    assert isinstance(counts, dict)
    out = capsys.readouterr().out
    assert f"{phase}: " in out


def test_resilience_refuses_a_pool_rebuild_that_rebuilds_nothing(
        rehearsal, monkeypatch):
    monkeypatch.setattr(PagedKVPool, "reset", lambda self: None)
    with pytest.raises(RuntimeError, match="inconsistent|leaked|audit"):
        chip_smoke.serve_resilience(CPU, "CPU", *rehearsal)


def test_fleet_refuses_replayed_tokens_delivered_twice(rehearsal,
                                                       monkeypatch):
    handle = FleetRouter._handle

    def no_dedup(self, rep, ev):
        if ev[0] == "tokens":
            freq = self.requests.get(ev[1])
            if freq is not None and ev[2] < len(freq.delivered):
                ev = (ev[0], ev[1], len(freq.delivered), ev[3])
        return handle(self, rep, ev)

    monkeypatch.setattr(FleetRouter, "_handle", no_dedup)
    with pytest.raises(RuntimeError, match="differs|states"):
        chip_smoke.serve_fleet(CPU, "CPU", *rehearsal)


def test_disagg_refuses_a_commit_that_drops_the_pin(rehearsal, monkeypatch):
    def release_instead(self, lease_id):
        pages = self._leases[lease_id]
        self.lease_release(lease_id)
        return pages

    monkeypatch.setattr(PagedKVPool, "lease_transfer", release_instead)
    with pytest.raises((RuntimeError, ValueError)):
        chip_smoke.serve_disagg(CPU, "CPU", *rehearsal)
