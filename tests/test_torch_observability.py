"""starcat_torch's JSONL metrics stream against the JAX package's, and the
port's own spans and counters (metrics.span / count, the benchmark's
readers of them, ``run --trace``).

The same small run of every head through both ``api.sample``s, on the CPU,
must write the same events in the same order with the same keys.  The values
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
import math
import os

import pytest
import torch

from starcat import api as japi
from starcat.configs import CONFIGS as JCONFIGS
from starcat.configs import apply_overrides as japply
from starcat_torch import api as tapi
from starcat_torch import chees as tchees
from starcat_torch import metrics as tmetrics
from starcat_torch import smc as tsmc
from starcat_torch.configs import CONFIGS as TCONFIGS
from starcat_torch.configs import apply_overrides as tapply
from starcat_torch.driver import init_chain_states
from starcat_torch.potential import PriorSpec, make_potential_and_grad, unconstrain
from starcat_torch.scene import SceneSpec, make_mock_image
from starcat_torch.transdim import TransDimConfig

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
    """profile_trace writes a Chrome trace and, beside it, the block's
    record: the spans opened in it (with their parents) and its counters;
    it clears what was recorded before, and is a no-op for None."""
    with tmetrics.tracing():
        with tmetrics.span("before"):
            pass
    with tmetrics.profile_trace(None):
        pass
    with tmetrics.profile_trace(str(tmp_path / "trace")):
        with tmetrics.span("outer"):
            with tmetrics.span("inner"):
                torch.ones(4).sum()
            tmetrics.count("things", torch.tensor([True, False, True]))
            tmetrics.count("things", 2, 3)
    names = sorted(p.name for p in (tmp_path / "trace").iterdir())
    assert names == [f"spans_{os.getpid()}.json", f"trace_{os.getpid()}.json"]
    trace = json.loads((tmp_path / "trace" / names[1]).read_text())
    assert {"outer", "inner"} <= {e.get("name") for e in trace["traceEvents"]}
    rec = json.loads((tmp_path / "trace" / names[0]).read_text())
    assert [(s["name"], s["parent"]) for s in rec["spans"]] == [("outer", None), ("inner", 0)]
    assert rec["counters"] == {"things": 8}
    for s in rec["spans"]:
        assert s["host_start_ns"] <= s["host_end_ns"] and s["host_ms"] >= 0
        assert "device_ms" not in s   # no device intervals off CUDA
    assert tmetrics.record() == rec
    tmetrics.reset_record()


# -- the program's spans and counters (metrics.span / metrics.count) ---------

T_SPEC = SceneSpec(8, 8, 1.5, 4.0)
T_PRIOR = PriorSpec(4.0, 0.7)
T_TRUTH = (torch.tensor([2.5, 5.2]), torch.tensor([3.1, 5.6]), torch.tensor([150.0, 90.0]))
SMC_SPANS = ["smc.temper", "smc.sweeps", "smc.mutate", "smc.refresh"]


@pytest.fixture(scope="module")
def image8():
    return make_mock_image(torch.Generator().manual_seed(0), *T_TRUTH, T_SPEC)


@pytest.fixture
def clean_record():
    tmetrics.reset_record()
    yield
    tmetrics.reset_record()


def _smc_steps(image, n_steps=2, wrap_sweep=None):
    """``n_steps`` seeded temperature steps from a seeded population of 16
    particles at K_max 3: two trans-d sweeps and one plain HMC mutation."""
    cfg = tsmc.SMCConfig(n_particles=16, mutation="hmc", n_mutation_steps=1, n_leapfrog=3,
                         n_transdim_sweeps=2, step_size0=0.05,
                         transdim=TransDimConfig(lam_count=2.0))
    g = torch.Generator().manual_seed(5)
    s = tsmc.init_smc(g, T_SPEC, image, T_PRIOR, 3, cfg)
    step = tsmc.make_smc_step(T_SPEC, image, T_PRIOR, 3, cfg)
    for _ in range(n_steps):
        s = step(s, tsmc.draw_step(g, 16, 3, T_SPEC, T_PRIOR, cfg, "cpu"))
    return s


def _chees_block(image, n=4, wrap_relocate=None, max_leapfrog=8):
    """``n`` seeded ChEES sampling iterations of 6 chains on the two-star
    scene, a relocate move an iteration, on the plain trajectory."""
    mask = torch.ones(2)
    pg = make_potential_and_grad(T_SPEC, image, T_PRIOR)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    g = torch.Generator().manual_seed(7)
    theta0 = unconstrain(*T_TRUTH, T_SPEC)[None] + 0.05 * torch.randn((6, 2, 3), generator=g)
    reloc = tchees.make_chees_relocate(T_SPEC, image, T_PRIOR, g)
    if wrap_relocate is not None:
        reloc = wrap_relocate(reloc)
    cfg = tchees.ChEESConfig(max_leapfrog=max_leapfrog)
    return tchees.chees_sample(init_chain_states(theta0, grad_fn), grad_fn, mask, n,
                               torch.tensor(0.05), torch.ones(2, 3), torch.tensor(0.3), cfg, g,
                               None, start=3, relocate_fn=reloc)


def test_tracing_off_records_nothing(image8, clean_record, monkeypatch):
    """Under no profiler and outside tracing(), an SMC step and a ChEES block
    never open a profiler range or make a CUDA event, every span is the one
    shared null context, and the record stays empty."""
    calls = []

    def counting(real):
        def f(*a, **k):
            calls.append(real)
            return real(*a, **k)
        return f

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    monkeypatch.setattr(torch.cuda, "Event", counting(torch.cuda.Event))
    monkeypatch.setattr(tmetrics._RECORDER, "count", counting(tmetrics._RECORDER.count))
    assert tmetrics.span("smc.step") is tmetrics.span("chees.iteration")
    _smc_steps(image8, 1)
    _chees_block(image8, 2)
    assert calls == [] and tmetrics.record() == {"spans": [], "counters": {}}


def test_spans_nest_under_the_profiler(image8, clean_record):
    """Under torch.profiler every span stands in the profiler's events, inside
    its parent: the SMC step's four layers in smc.step, the trajectory and
    the relocate move in chees.iteration."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _smc_steps(image8, 1)
        _chees_block(image8, 2)
    parents = {}
    for e in prof.events():
        if e.name.startswith(("smc.", "chees.")):
            parents.setdefault(e.name, set()).add(e.cpu_parent.name if e.cpu_parent else None)
    assert parents == {"smc.step": {None}, **{n: {"smc.step"} for n in SMC_SPANS},
                       "chees.iteration": {None}, "chees.trajectory": {"chees.iteration"},
                       "chees.relocate": {"chees.iteration"}}
    rec = tmetrics.record()
    assert [s["name"] for s in rec["spans"]][:5] == ["smc.step"] + SMC_SPANS


def test_smc_step_spans_and_children(image8, clean_record):
    """A three-step run records one smc.step a step, each with the four
    children in order and no other span; each child lies inside its step."""
    with tmetrics.tracing():
        _smc_steps(image8, 3)
    spans = tmetrics.record()["spans"]
    steps = [i for i, s in enumerate(spans) if s["name"] == "smc.step"]
    assert len(steps) == 3 and len(spans) == 15
    for i in steps:
        kids = [s for s in spans if s["parent"] == i]
        assert [s["name"] for s in kids] == SMC_SPANS
        assert spans[i]["parent"] is None
        for s in kids:
            assert spans[i]["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"]
            assert s["host_end_ns"] <= spans[i]["host_end_ns"]


def test_transdim_counters_match_the_sweeps(image8, clean_record, monkeypatch):
    """transdim.accepted is the sum of the accepted flags every sweep returns;
    transdim.moves is particles x sweeps; transdim.kernel_moves counts none
    of them on the CPU, where the sweeps run the plain version."""
    seen = []
    real = tsmc.poisson_sweep

    def sweep(*a, **k):
        out = real(*a, **k)
        seen.append(int(out[3].accepted.sum()))
        return out

    monkeypatch.setattr(tsmc, "poisson_sweep", sweep)
    with tmetrics.tracing():
        _smc_steps(image8, 3)
    counters = tmetrics.record()["counters"]
    assert len(seen) == 6 and sum(seen) > 0
    assert counters == {"transdim.accepted": sum(seen), "transdim.moves": 16 * 6,
                        "transdim.kernel_moves": 0}


def test_relocate_and_leapfrog_counters(image8, clean_record):
    """chees.relocations_accepted is the sum of relocate_fn's accepted flags,
    chees.relocations the chains a relocate sweep, and chees.leapfrog_steps
    chains x clamp(ceil(u_i T / eps), 1, cap) over the iterations (u_i the
    Halton point of iteration i)."""
    seen = []

    def wrap(reloc):
        def f(theta, mask):
            out = reloc(theta, mask)
            seen.append(int(out[1].sum()))
            return out
        return f

    with tmetrics.tracing():
        _chees_block(image8, 5, wrap_relocate=wrap, max_leapfrog=5)
    counters = tmetrics.record()["counters"]
    steps = [min(max(math.ceil(float(torch.tensor(tchees._halton2(i)) * torch.tensor(0.3)
                                      / torch.tensor(0.05))), 1), 5) for i in range(3, 8)]
    assert len(seen) == 5 and steps == [5, 1, 4, 3, 5]   # the cap cuts iteration 7's 6
    assert counters == {"chees.relocations": 6 * 5, "chees.relocations_accepted": sum(seen),
                        "chees.leapfrog_steps": 6 * sum(steps)}


@pytest.mark.parametrize("head", ["smc", "chees"])
def test_tracing_leaves_the_bits(image8, clean_record, head):
    """The same seeded SMC steps or ChEES block give the same bits with
    tracing off, inside tracing() and under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        if head == "smc":
            s = _smc_steps(image8, 2)
            return [s.theta, s.mask, s.loglik, s.beta, s.log_z, s.eps]
        r = _chees_block(image8, 3)
        return [r.thetas, r.accept_prob, r.final_states.u, r.final_states.grad]

    off = run()
    with tmetrics.tracing():
        on = run()
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = run()
    assert tmetrics.record()["spans"]
    for a, b, c in zip(off, on, profiled):
        assert torch.equal(a, b) and torch.equal(a, c)


def _span(name, parent, host_ms, device_ms):
    return {"name": name, "parent": parent, "host_start_ns": 0,
            "host_end_ns": int(host_ms * 1e6), "host_ms": host_ms,
            "device_start_ns": 0, "device_end_ns": int(device_ms * 1e6), "device_ms": device_ms}


# two SMC steps and two ChEES iterations (one relocating), by hand
HAND_RECORD = {
    "spans": [_span("smc.step", None, 40.0, 100.0), _span("smc.temper", 0, 2.0, 3.0),
              _span("smc.sweeps", 0, 20.0, 30.0), _span("smc.mutate", 0, 15.0, 60.0),
              _span("smc.refresh", 0, 1.0, 5.0),
              _span("smc.step", None, 50.0, 110.0), _span("smc.temper", 5, 2.0, 5.0),
              _span("smc.sweeps", 5, 20.0, 34.0), _span("smc.mutate", 5, 15.0, 64.0),
              _span("smc.refresh", 5, 1.0, 5.0),
              _span("chees.iteration", None, 12.0, 50.0), _span("chees.trajectory", 10, 1.0, 45.0),
              _span("chees.relocate", 10, 9.0, 3.0),
              _span("chees.iteration", None, 14.0, 48.0), _span("chees.trajectory", 13, 1.0, 47.0)],
    "counters": {"transdim.moves": 400, "transdim.accepted": 30, "chees.relocations": 64,
                 "chees.relocations_accepted": 4, "chees.leapfrog_steps": 9000},
}
READERS = {
    "sweeps_ms_per_step.smc": ("smc", 32.0), "tempering_ms_per_step.smc": ("smc", 4.0),
    "mutation_ms_per_step.smc": ("smc", 62.0), "host_ms_per_step.smc": ("smc", 45.0),
    "transdim_accept.smc": ("smc", 7.5), "relocate_ms_per_iter.chees": ("chees", 1.5),
    "host_ms_per_iter.chees": ("chees", 13.0), "relocate_accept.chees": ("chees", 6.25),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_program_trace_readers(name, monkeypatch):
    """Each reader of the program's record gives None on an empty record,
    for another head, and where the record has no device intervals (for a
    device metric), and its value on a record built by hand."""
    from benchmark import core

    head, want = READERS[name]
    read = core.reader(name)

    def run(head_name):
        return type("Run", (), {"head": type("H", (), {"name": head_name})(),
                                "trace": None, "counters": {}})()

    monkeypatch.setattr(tmetrics, "record", lambda: {"spans": [], "counters": {}})
    assert read(run(head)) is None
    monkeypatch.setattr(tmetrics, "record", lambda: HAND_RECORD)
    assert read(run(head)) == pytest.approx(want, rel=1e-12)
    assert read(run("chees" if head == "smc" else "smc")) is None
    host_only = {"spans": [{k: v for k, v in s.items() if not k.startswith("device")}
                           for s in HAND_RECORD["spans"]], "counters": HAND_RECORD["counters"]}
    monkeypatch.setattr(tmetrics, "record", lambda: host_only)
    assert (read(run(head)) is None) == ("host" not in name and "accept" not in name)
    monkeypatch.delattr(tmetrics, "record")
    assert read(run(head)) is None   # a program without the recorder


def test_run_cli_trace_writes_the_trace_and_the_spans(tmp_path, capsys):
    """run --trace DIR profiles the job: the Chrome trace and the program's
    spans and counters land in DIR, one chees.iteration a sampling draw."""
    from starcat_torch.__main__ import main

    d = tmp_path / "tr"
    main(["run", "--config", "cfg6_chees", "n_chains=4", "n_warmup=10", "n_samples=6",
          "chees.max_leapfrog=4", "--device", "cpu", "--trace", str(d)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["head"] == "chees"
    rec = json.loads((d / f"spans_{os.getpid()}.json").read_text())
    assert (d / f"trace_{os.getpid()}.json").exists()
    assert sum(s["name"] == "chees.iteration" for s in rec["spans"]) == 6
    assert rec["counters"]["chees.relocations"] >= 4 * 6
    tmetrics.reset_record()
