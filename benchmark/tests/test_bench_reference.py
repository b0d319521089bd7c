"""The plain reference agrees with the port's plain path at a tiny size (in
float64, to rounding), and imports neither JAX, the JAX package nor the
port."""
from __future__ import annotations

import ast
import contextlib

import pytest
import torch

from benchmark import core
from benchmark.reference import model, moves, steps
from starcat_torch import chees as pchees
from starcat_torch import fused_rhmc, fused_rhmc_diag, metric, potential, transdim
from starcat_torch.potential import PriorSpec
from starcat_torch.scene import SceneSpec

F64 = torch.float64
SC = model.Scene(12, 10, 1.5, 10.0)
PR = model.Prior(5.0, 0.7)
SPEC, PRIOR = SceneSpec(*SC), PriorSpec(*PR)


def _scene(c=6, k=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    theta = torch.cat([torch.randn((c, k, 2), generator=g, dtype=F64) * 0.8,
                       5.0 + 0.7 * torch.randn((c, k, 1), generator=g, dtype=F64)], dim=-1)
    image = torch.poisson(torch.full((SC.height, SC.width), 40.0, dtype=F64), generator=g)
    mask = (torch.rand((c, k), generator=g, dtype=F64) < 0.75).to(F64)
    mask[:, 0] = 1.0
    return g, theta, image, mask


def _gumbel(g, *shape):
    return -torch.log(-torch.log(torch.rand(shape, generator=g, dtype=F64).clamp(min=1e-30)))


def test_reference_imports_nothing_of_the_program():
    for path in (core.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            tops = {n.split(".")[0] for n in names}
            assert not tops & {"jax", "jaxlib", "flax", "starcat", "starcat_torch", "benchmark"}, path


def test_potential_and_metrics():
    _, theta, image, mask = _scene()
    u, gr = model.potential_and_grad(theta, mask, SC, PR, image)
    u2, g2 = potential.make_potential_and_grad(SPEC, image, PRIOR)(theta, mask)
    assert torch.allclose(u, u2, rtol=1e-13) and torch.allclose(gr, g2, rtol=1e-12, atol=1e-12)
    for beta in (0.3, 1.0):
        assert torch.allclose(model.diag_metric(theta, mask, SC, PR, beta),
                              metric.make_diag_metric_fn(SPEC, PRIOR)(theta, mask, beta),
                              rtol=1e-12)
        assert torch.allclose(model.dense_metric(theta, mask, SC, PR, beta),
                              metric.make_metric_fn(SPEC, PRIOR)(theta, mask, beta), rtol=1e-12,
                              atol=1e-12)


def test_relocate():
    g, theta, image, _ = _scene(c=8, k=3, seed=1)
    mask = torch.ones(3, dtype=F64)
    ll = model.log_likelihood(theta, mask, SC, image)
    d = (_gumbel(g, 8, 3), _gumbel(g, 8, SC.height * SC.width),
         torch.rand((8, 2), generator=g, dtype=F64), torch.randn((8,), generator=g, dtype=F64),
         torch.rand((8,), generator=g, dtype=F64))
    th, acc = moves.relocate(theta, mask, ll, PR, SC, image, *d, 1e-2, 0.1, 0.12)
    th2, _, _, info = transdim.relocate_step(theta, mask, ll, PRIOR, SPEC, image, *d, 1e-2, 0.1,
                                             0.12)
    assert torch.equal(acc, info.accepted) and torch.allclose(th, th2, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("births", ["residual", "prior"])
def test_sweep(births):
    g, theta, image, mask = _scene(c=16, k=5, seed=2)
    td = {"lam_count": 4.0, "split_sigma": 1.0, "p_birth_death": 0.5, "fmin": 1e-3,
          "birth_proposal": births, "resid_floor": 1e-2}
    c, k = mask.shape

    def r(*s):
        return torch.rand(s, generator=g, dtype=F64)

    if births == "residual":
        bd = (r(c), _gumbel(g, c, k), _gumbel(g, c, SC.height * SC.width), r(c, 2),
              torch.randn((c,), generator=g, dtype=F64), r(c))
    else:
        bd = (r(c), _gumbel(g, c, k), torch.randn((c, 3), generator=g, dtype=F64), r(c))
    sm = (r(c), _gumbel(g, c, k), _gumbel(g, c, k), r(c),
          torch.randn((c, 2), generator=g, dtype=F64), r(c))
    beta = 0.4

    def llf(th, m):
        return beta * model.log_likelihood(th, m, SC, image)

    tll = llf(theta, mask)
    th, m, ll = moves.sweep(theta, mask, tll, llf, PR, SC, image, td, (r(c) * 0 + 0.3, bd, sm))
    th2, m2, ll2, _ = transdim.transdim_sweep(
        theta, mask, tll, llf, PRIOR, SPEC, transdim.TransDimConfig(**td),
        transdim.SweepDraws(r(c) * 0 + 0.3, bd, sm), image)
    assert torch.equal(m, m2) and torch.allclose(th, th2, rtol=1e-12, atol=1e-12)
    assert torch.allclose(ll, ll2, rtol=1e-12)


@pytest.mark.parametrize("which", ["diag", "full"])
def test_rhmc_trajectory(which):
    g, theta, image, mask = _scene(c=4, k=3, seed=3)
    xi = torch.randn(theta.shape, generator=g, dtype=F64)
    eps = torch.full((4,), 0.05, dtype=F64)
    th, h0, h1, res = steps.rhmc_trajectory(theta, xi, eps, mask, 0.7, SC, PR, image, which, 3, 2)
    plain = (fused_rhmc_diag.fused_rhmc_diag_reference if which == "diag"
             else fused_rhmc.fused_rhmc_reference)
    th2, _, h02, h12, _, res2 = plain(SPEC, image, PRIOR, theta, xi, eps, mask, 0.7, 3, 2)
    for a, b in ((th, th2), (h0, h02), (h1, h12), (res, res2)):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-10)


def test_chees_iteration():
    from starcat_torch.driver import ChainState

    g, theta, image, _ = _scene(c=6, k=3, seed=4)
    mask = torch.ones(3, dtype=F64)
    inv_mass = 0.5 + torch.rand((3, 3), generator=g, dtype=F64)
    p0 = torch.randn(theta.shape, generator=g, dtype=F64)
    u_acc = torch.rand((6,), generator=g, dtype=F64)
    rd = (_gumbel(g, 6, 3), _gumbel(g, 6, SC.height * SC.width),
          torch.rand((6, 2), generator=g, dtype=F64), torch.randn((6,), generator=g, dtype=F64),
          torch.rand((6,), generator=g, dtype=F64))
    reloc = {"resid_floor": 1e-2, "flux_sigma": 0.1, "pos_sigma": 0.12}
    eps = torch.tensor(0.02, dtype=F64)
    th, ap, _ = steps.chees_iteration(theta, SC, PR, image, eps, inv_mass, 7, 1000.0, p0, u_acc, rd,
                                   reloc)
    pg = potential.make_potential_and_grad(SPEC, image, PRIOR)
    u, gr = pg(theta, mask)
    st, info, _ = pchees._chees_iteration(ChainState(theta, u, gr), lambda t: pg(t, mask), eps,
                                          inv_mass, mask, 0.5, torch.tensor(0.26, dtype=F64),
                                          1024, 1000.0, p0, u_acc)
    assert int(info.n_leapfrog) == 7
    ll = potential.log_likelihood(st.theta, mask, SPEC, image)
    th2 = transdim.relocate_step(st.theta, mask, ll, PRIOR, SPEC, image, *rd, **reloc)[0]
    assert torch.allclose(ap, info.accept_prob, rtol=1e-10) and torch.allclose(
        th, th2, rtol=1e-10, atol=1e-10)


def test_chees_iteration_takes_each_rows_step_count():
    """Rows of several blocks in one batch, each with its own step count,
    give the same bits as each block's rows alone."""
    g, theta, image, _ = _scene(c=6, k=3, seed=5)
    inv_mass = 0.5 + torch.rand((3, 3), generator=g, dtype=F64)
    p0 = torch.randn(theta.shape, generator=g, dtype=F64)
    u_acc = torch.rand((6,), generator=g, dtype=F64)
    rd = (_gumbel(g, 6, 3), _gumbel(g, 6, SC.height * SC.width),
          torch.rand((6, 2), generator=g, dtype=F64), torch.randn((6,), generator=g, dtype=F64),
          torch.rand((6,), generator=g, dtype=F64))
    reloc = {"resid_floor": 1e-2, "flux_sigma": 0.1, "pos_sigma": 0.12}
    eps = torch.tensor(0.02, dtype=F64)
    counts = [1, 1, 9, 9, 4, 4]
    batch = steps.chees_iteration(theta, SC, PR, image, eps, inv_mass, torch.tensor(counts),
                                  1000.0, p0, u_acc, rd, reloc)
    for a in (0, 2, 4):
        sl = slice(a, a + 2)
        alone = steps.chees_iteration(theta[sl], SC, PR, image, eps, inv_mass, counts[a], 1000.0,
                                      p0[sl], u_acc[sl], tuple(t[sl] for t in rd), reloc)
        assert all(torch.equal(x[sl], y) for x, y in zip(batch, alone))


@pytest.mark.parametrize("workload", ["flagship.chees", "flagship.smc", "crowded.smc"])
def test_program_plain_path_agrees_in_a_run(workload):
    """At the rehearsal size on the CPU the port runs its plain path in
    float32; the float64 reference following it finds no row off."""
    cell = core.load_cell(workload)
    mod = __import__(f"benchmark.heads.{cell['traffic_data']['head']}", fromlist=["Head"])
    head = mod.Head(cell, 11, torch.device("cpu"), cell["traffic_data"]["rehearsal"])
    head.setup()
    head.window(0.1, lambda name: contextlib.nullcontext())
    out = head.check()
    assert all(v <= cell["limits"][k] for k, v in out.items()), out
    assert out.get("draws_off", 0.0) == 0.0 and out.get("particles_off", 0.0) == 0.0


def test_halton_jitter_and_step_count():
    assert all(steps.halton2(i) == pchees._halton2(i) for i in range(5000))
    eps, traj = torch.tensor(0.01034, dtype=torch.float32), torch.tensor(62.86, dtype=torch.float32)
    for i in range(0, 5000, 7):
        n = torch.clamp(torch.ceil(pchees._halton2(i) * traj / eps), 1, 1024).to(torch.int32)
        assert steps.chees_steps(steps.halton2(i), float(traj), float(eps), 1024) == int(n)
