"""The comparison that decides ``correct`` fails what it should: a run with
the timed path broken underneath comes out not correct (a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced; one card, so no exchange between cards to leave
out), and the control, the reference in bfloat16 in the program's place,
reads over at least one limit.  Every cell, at its rehearsal size on the
CPU; a sound run of each is correct."""
from __future__ import annotations

import torch

import pytest

from benchmark import control, core, run
from benchmark.heads import chees, smc

CELLS = ["flagship.chees", "flagship.smc", "crowded.smc"]


def _chees_fault(kind):
    def plant(head):
        impl = head.impl

        def broken(theta, p, u, grad, eps, n_steps, inv_mass, mask):
            if kind == "unchanged":
                return theta, p, u, grad
            out = list(impl(theta, p, u, grad, eps, n_steps, inv_mass, mask))
            if kind == "half":
                h = theta.shape[0] // 2
                out = [torch.cat([o[:h], i[h:]]) for o, i in zip(out, (theta, p, u, grad))]
            else:
                out[0] = out[0] + torch.tensor([0.0, 0.0, 0.01])
            return tuple(out)

        head.impl = broken
    return plant


def _smc_fault(kind):
    def plant(head):
        step = head.step

        def broken(s, draws):
            if kind == "unchanged":
                return s
            s1 = step(s, draws)
            if kind == "half":
                # half the population left out, log Z's mean taken over the rest
                h = s.theta.shape[0] // 2
                db = s1.beta - s.beta
                log_z = s.log_z + torch.logsumexp(db * s.loglik[:h], 0) - torch.log(
                    torch.tensor(float(h)))
                return s1._replace(theta=torch.cat([s1.theta[:h], s.theta[h:]]),
                                   mask=torch.cat([s1.mask[:h], s.mask[h:]]), log_z=log_z)
            return s1._replace(theta=s1.theta + torch.tensor([0.0, 0.0, 0.01]))

        head.step = broken
    return plant


def _run(monkeypatch, workload, plant=None):
    mod = chees if core.load_cell(workload)["traffic_data"]["head"] == "chees" else smc
    setup = mod.Head.setup

    def planted(self):
        setup(self)
        if plant is not None:
            plant(self)

    monkeypatch.setattr(mod.Head, "setup", planted)
    # this test process has JAX loaded (the repository's conftest); the
    # import check runs in processes of its own (test_bench_imports.py)
    monkeypatch.setattr(core, "forbidden_modules", lambda: [])
    return run.main(["--workload", workload, "--seed", "2147483659", "--seconds", "0.3",
                     "--rehearse"])


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(monkeypatch, workload):
    assert _run(monkeypatch, workload) == 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(monkeypatch, workload, kind):
    head = core.load_cell(workload)["traffic_data"]["head"]
    fault = _chees_fault(kind) if head == "chees" else _smc_fault(kind)
    assert _run(monkeypatch, workload, fault) == 1


@pytest.mark.parametrize("workload", [c for c in CELLS if c.endswith(".chees")])
def test_unadapted_warmup_is_not_correct(monkeypatch, workload):
    """The warm-up returns its state unchanged (the starting step size,
    trajectory length and unit mass): accept_gap reads over its limit."""
    assert _run(monkeypatch, workload, control.FAULTS["unadapted"]) == 1


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_over_a_limit(workload):
    cell = core.load_cell(workload)
    (seed, prog, ctrl, _), = control.readings(workload, [2147483661], 0.3, torch.device("cpu"),
                                             cell["traffic_data"]["rehearsal"])
    assert all(v <= cell["limits"][k] for k, v in prog.items()), prog
    assert any(v > cell["limits"][k] for k, v in ctrl.items()), ctrl
