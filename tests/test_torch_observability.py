"""starcat_torch's JSONL metrics stream against the JAX package's: the same
small run of every head through both ``api.sample``s, on the CPU, must
write the same events in the same order with the same keys.  The values
differ (JAX keys and torch generators never give the same draws), so only
those that need no shared draws are compared: the blocks' ``done``
sequence and ``n_total``, the warmup phases, the ADVI windows and the SMC
schedule.  Neither package writes ``warmup_t_probe``: the probe is off at
the presets' ``t_probe_iters = 0`` and not ported.

ChEES runs with gates whose outcome does not depend on the draws: one
T extension (t_drift_tol below any drift, so the run also warns that T did
not settle) and one equilibration stage (eq_tol above any disagreement).
SMC takes its full step to beta = 1 at once, so its step count does not
depend on them either; a separate pass holds each package's own tempering
records to its schedule.
"""
from __future__ import annotations

import json

import pytest
import torch

from starcat import api as japi
from starcat.configs import CONFIGS as JCONFIGS
from starcat.configs import apply_overrides as japply
from starcat_torch import api as tapi
from starcat_torch import metrics as tmetrics
from starcat_torch.configs import CONFIGS as TCONFIGS
from starcat_torch.configs import apply_overrides as tapply

torch.set_num_threads(1)

SMALL = {"n_chains": "4", "n_samples": "8", "n_warmup": "8"}
HEADS = {
    "hmc": {},
    "nuts": {"nuts.max_depth": "4"},
    "chees": {"chees.max_leapfrog": "32", "chees.t_drift_tol": "-1.0",
              "chees.max_warmup_extensions": "1", "chees.max_eq_stages": "1",
              "chees.eq_tol": "1e9"},
    "rhmc": {"rhmc.n_leapfrog": "3", "rhmc.fixed_point_iters": "2"},
    # the first step goes to beta = 1 at this ESS target, then two posterior
    # rounds: three steps in both packages whatever the draws
    "smc": {"smc.n_particles": "32", "smc.mutation": "hmc", "smc.n_leapfrog": "3",
            "smc.n_mutation_steps": "1", "smc.ess_target_frac": "1e-6",
            "smc.n_final_rounds": "2", "smc.n_islands": "2"},
    "transdim": {"tdm.n_leapfrog": "3"},
    "advi": {"advi.n_steps": "50"},
}
# run_complete carries every numeric stat, and the packages' stats differ:
# the port also counts its kernels' launches and SMC's divergences and
# solver rejections; the JAX ChEES head reports the T probe's factor (1.0
# with the probe off), which the port does not have
PORT_ONLY = {"kernel_launches"}
PORT_ONLY_SMC = {"divergences", "solver_rejections"}
JAX_ONLY_CHEES = {"t_probe_factor"}


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture(scope="module", params=sorted(HEADS))
def streams(request, tmp_path_factory):
    head = request.param
    over = dict(SMALL, head=head, **HEADS[head])
    d = tmp_path_factory.mktemp(head)
    # a checkpoint path makes the MCMC heads sample in blocks of n // 4
    japi.sample(japply(JCONFIGS["cfg0_single_star"], over), seed=0,
                metrics_path=str(d / "jax.jsonl"), checkpoint_path=str(d / "jax_ck"))
    tapi.sample(tapply(TCONFIGS["cfg0_single_star"], over), "cpu", seed=0,
                metrics_path=str(d / "torch.jsonl"), checkpoint_path=str(d / "torch_ck"))
    return head, _events(d / "jax.jsonl"), _events(d / "torch.jsonl")


def test_same_events_in_the_same_order_with_the_same_keys(streams):
    head, jev, tev = streams
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    for j, t in zip(jev, tev):
        jk, tk = set(j), set(t)
        if j["event"] == "run_complete":
            port_only = PORT_ONLY | (PORT_ONLY_SMC if head == "smc" else set())
            jax_only = JAX_ONLY_CHEES if head == "chees" else set()
            assert tk - jk == port_only and jk - tk == jax_only, (tk - jk, jk - tk)
        else:
            assert tk == jk, (j["event"], tk ^ jk)
        assert t["run"] == j["run"] == "cfg0_single_star"
    assert tev[-1]["event"] == "run_complete" and tev[-1]["head"] == head


def test_values_that_need_no_shared_draws(streams):
    head, jev, tev = streams
    for ev in (jev, tev):
        kinds = [e["event"] for e in ev]
        blocks = [e for e in ev if e["event"] == "sampling_block"]
        if head in ("hmc", "nuts", "chees", "rhmc", "transdim"):
            assert [b["done"] for b in blocks] == [2, 4, 6, 8]
            if head != "transdim":
                assert all(b["n_total"] == 8 for b in blocks)
                phases = [e for e in ev if e["event"] == "warmup_phase"]
                assert [p["phase"] for p in phases] == [1, 2, 3]
                assert all(0 <= p["accept"] <= 1 and p["step_size"] > 0 for p in phases)
            assert all(0 <= b["accept"] <= 1 for b in blocks)
        if head == "chees":
            assert kinds.count("warmup_t_extension") == 1
            assert kinds.count("warmup_eq_stage") == 1 and kinds.count("warmup_complete") == 1
            assert [e["kind"] for e in ev if e["event"] == "warning"] == [
                "traj_adaptation_unconverged"]
            assert all(b["traj_length"] > 0 for b in blocks)
        if head == "transdim":
            wins = [e for e in ev if e["event"] == "warmup_window"]
            assert [w["window"] for w in wins] == [0, 1, 2, 3]
            assert all(0 <= w["td_accept"] <= 1 and w["step_size"] > 0 for w in wins)
        if head == "advi":
            wins = [e for e in ev if e["event"] == "advi_window"]
            assert [(w["step_lo"], w["step_hi"]) for w in wins] == [
                (0, 10), (10, 20), (20, 30), (30, 40), (40, 50)]
        if head == "smc":
            steps = [e for e in ev if e["event"] == "smc_temperature_step"]
            assert [(s["step"], s["beta"]) for s in steps] == [(1, 1.0), (2, 1.0), (3, 1.0)]
            assert ev[-1]["n_temp_steps"] == 3 and ev[-1]["final_rounds"] == 2
            assert kinds.count("smc_island_diag") == 1


def test_smc_tempering_records_one_step_each_with_beta_rising_to_one(tmp_path):
    """Each package's own tempering pass: one record a step, numbered from
    1, beta rising to 1, log Z of the last record the run's."""
    over = dict(SMALL, head="smc", **{"smc.n_particles": "32", "smc.mutation": "hmc",
                                      "smc.n_leapfrog": "3", "smc.n_mutation_steps": "1"})
    jp, tp = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jout = japi.sample(japply(JCONFIGS["cfg0_single_star"], over), seed=0, metrics_path=jp)
    tout = tapi.sample(tapply(TCONFIGS["cfg0_single_star"], over), "cpu", seed=0,
                       metrics_path=tp)
    for path, out in ((jp, jout), (tp, tout)):
        ev = _events(path)
        steps = [e for e in ev if e["event"] == "smc_temperature_step"]
        assert len(steps) > 2 and len(steps) == out.stats["n_temp_steps"]
        assert [s["step"] for s in steps] == list(range(1, len(steps) + 1))
        betas = [s["beta"] for s in steps]
        assert betas == sorted(betas) and betas[0] < 1.0 and betas[-1] == 1.0
        assert steps[-1]["log_z"] == pytest.approx(out.stats["log_z"], rel=1e-6)
        assert [e["event"] for e in ev][-1] == "run_complete"


def test_port_default_blocks_of_250(tmp_path):
    """Without a checkpoint, more than 300 draws sample in uniform blocks of
    at most 250 (the reference's policy): 400 draws in two of 200."""
    mp = str(tmp_path / "m.jsonl")
    cfg = tapply(TCONFIGS["cfg0_single_star"], dict(SMALL, head="hmc", n_samples="400"))
    out = tapi.sample(cfg, "cpu", seed=0, metrics_path=mp)
    blocks = [e for e in _events(mp) if e["event"] == "sampling_block"]
    assert [(b["done"], b["n_total"]) for b in blocks] == [(200, 400), (400, 400)]
    assert out.thetas.shape == (4, 400, 1, 3)


def test_logger_on_a_rank_other_than_0_writes_nothing(tmp_path, monkeypatch):
    path = tmp_path / "rank1.jsonl"
    monkeypatch.setattr(tmetrics, "_rank", lambda: 1)
    log = tmetrics.MetricsLogger(str(path), "r")
    log.log("sampling_block", done=1)
    log.close()
    assert not path.exists()
    monkeypatch.setattr(tmetrics, "_rank", lambda: 0)
    log = tmetrics.MetricsLogger(str(path), "r")
    log.log("sampling_block", done=1, ok=True, name="x")
    log.close()
    (rec,) = _events(path)
    assert rec["event"] == "sampling_block" and rec["done"] == 1.0 and rec["ok"] == 1.0
    assert rec["name"] == "x" and rec["run"] == "r"


def test_timed_and_profile_trace(tmp_path):
    """timed logs the wall of its block; profile_trace writes a Chrome
    trace, and is a no-op for None."""
    path = tmp_path / "t.jsonl"
    log = tmetrics.MetricsLogger(str(path), "r")
    with tmetrics.timed(log, "phase", device="cpu", n=3):
        torch.ones(4).sum()
    log.close()
    (rec,) = _events(path)
    assert rec["event"] == "phase" and rec["wall_seconds"] >= 0 and rec["n"] == 3
    with tmetrics.profile_trace(None):
        pass
    with tmetrics.profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    (trace,) = (tmp_path / "trace").iterdir()
    assert "traceEvents" in json.loads(trace.read_text())
