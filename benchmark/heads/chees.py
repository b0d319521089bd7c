"""ChEES: the port's run_chees warms the chains up (500 iterations, the
T-drift extensions and the equilibration gate, as the preset does), then
the window runs chees.chees_sample in blocks, keeping the total flux of
every draw (for the ESS, on the host) and, of a seeded sample of blocks,
the first draws (for the check).

The warm-up draws from a generator seeded by the traffic file's
``warmup_seed``, so every run adapts the same step size, mass and
trajectory length and does the same work; ``--seed`` seeds the window's
generator (its momenta, acceptance uniforms and relocate draws).

The check follows the program: for a sample of the window's blocks it
takes the chains before the block, replays the block's first iteration's
draws from the generator's state (the momenta and the acceptance uniform,
then the relocate move's five draws, in the order chees_sample consumes
them) and runs the reference's iteration in float64 on a seeded sample of
the chains.  The step size, mass and trajectory length it runs at are the
program's warm-up's: the check holds the step size to its own rule
(accept_gap), not the warm-up step by step."""
from __future__ import annotations

import time

import torch

from .. import opcount
from ..reference import steps as ref
from . import common


def replay_draws(state: torch.Tensor, c: int, k: int, hw: int, device) -> tuple:
    """One iteration's draws as chees_sample consumes them from a generator
    in ``state``: p0 (C, K, 3), u_acc (C,), then the relocate move's g_slot,
    g_pix (Gumbel), u_sub (C, 2), z (C,), u_acc (C,)."""
    g = torch.Generator(device=device)
    g.set_state(state)
    tiny = torch.finfo(torch.float32).tiny

    def gumbel(*shape):
        u = torch.rand(shape, generator=g, device=device).clamp_(min=tiny)
        return -torch.log(-torch.log(u))

    p0 = torch.randn((c, k, 3), generator=g, device=device)
    u_acc = torch.rand((c,), generator=g, device=device)
    reloc = (gumbel(c, k), gumbel(c, hw), torch.rand((c, 2), generator=g, device=device),
             torch.randn((c,), generator=g, device=device),
             torch.rand((c,), generator=g, device=device))
    return p0, u_acc, reloc


class Head:
    name = "chees"

    def __init__(self, cell: dict, seed: int, device: torch.device, overrides: dict | None = None):
        self.cfg = cell["config_data"]
        self.tr = {**cell["traffic_data"], **(overrides or {})}
        self.limits = cell["limits"]
        self.seed, self.device = seed, device
        self.sc, self.pr = common.scene_and_prior(self.cfg)
        self.k = common.capacity(self.cfg, self.tr)
        self.c = int(self.tr["n_chains"])
        self.counters: dict = {}
        self.ops: dict = {}

    def setup(self) -> None:
        from starcat_torch import chees, dispatch
        from starcat_torch.potential import PriorSpec, make_potential_and_grad
        from starcat_torch.scene import SceneSpec

        dev, tr = self.device, self.tr
        truth, image = common.mock_scene(self.cfg)
        self.image = image.to(dev)
        spec, prior = SceneSpec(*self.sc), PriorSpec(*self.pr)
        self.mask = torch.ones(self.k, dtype=torch.float32, device=dev)
        pg = make_potential_and_grad(spec, self.image, prior)
        self.grad_fn = lambda th: pg(th, self.mask)  # noqa: E731
        self.impl = chees.make_fused_leapfrog_impl(spec, self.image, prior, self.k)
        self.kernel = dispatch.trajectory_kernel("chees", None, spec, self.k)
        self.ccfg = chees.ChEESConfig(**tr["chees"])
        gw = torch.Generator(device=dev)
        gw.manual_seed(int(tr["warmup_seed"]))
        theta0 = truth.to(dev)[None] + 0.01 * torch.randn(
            (self.c, self.k, 3), generator=gw, device=dev)
        reloc_w = chees.make_chees_relocate(spec, self.image, prior, gw, **tr["relocate"])
        res, ad = chees.run_chees(gw, self.grad_fn, theta0, self.mask, 0, int(tr["n_warmup"]),
                                  self.ccfg, leapfrog_impl=self.impl, relocate_fn=reloc_w)
        self.eps, self.inv_mass, self.traj = ad["step_size"], ad["inv_mass"], ad["traj_length"]
        self.adapted = {k: v for k, v in ad.items() if isinstance(v, (int, float))}
        self.adapted.update(step_size=float(self.eps), traj_length=float(self.traj))
        # one more block on the warm-up generator: every shape of the window built
        self.block = int(tr["block"])
        self.done = int(tr["n_warmup"])
        self.states = self._block(res.final_states, gw, reloc_w).final_states
        self.done += self.block
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.seed)
        self.reloc = chees.make_chees_relocate(spec, self.image, prior, self.gen, **tr["relocate"])
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _block(self, states, gen, reloc):
        from starcat_torch import chees

        return chees.chees_sample(states, self.grad_fn, self.mask, self.block, self.eps,
                                  self.inv_mass, self.traj, self.ccfg, gen, self.impl,
                                  start=self.done, relocate_fn=reloc)

    def window(self, seconds: float, span) -> float:
        """Blocks of chees_sample until ``seconds`` have passed; returns the
        window's length.  ``span(name)`` opens a named region of the trace.
        Each block's total fluxes go to the host at its sync; of a seeded
        sample of blocks (a reservoir: the window's memory does not grow
        with its length) the generator's state, the chains before it and
        its first draws stay for the check."""
        self.sample = common.Sample(self.seed, int(self.tr["check"]["blocks"]) - 1)
        flux = []
        st, start = self.states, self.done
        t0 = time.perf_counter()
        while True:
            state = self.gen.get_state()
            with span("bench.chees_sample"):
                res = self._block(st, self.gen, self.reloc)
                block_flux = torch.exp(res.thetas[..., 2]).sum(-1)
                self.sample.offer(len(flux), lambda: (  # noqa: B023
                    state, st.theta, res.thetas[:, 0].clone(), self.done))
            st = res.final_states
            self.done += self.block
            with span("bench.sync"):
                flux.append(block_flux.cpu())
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        self.states = st
        self.flux = torch.cat(flux, dim=1)
        n_iter = self.done - start
        steps = [self.n_steps(i) for i in range(start, self.done)]
        self.counters = {"iterations": n_iter, "draws": self.c * n_iter,
                         "leapfrog_steps": self.c * sum(steps), "window_s": window_s}
        h, w = self.sc.height, self.sc.width
        traj_ops = sum(opcount.leapfrog_ops(self.c, self.k, h, w, n, True) for n in steps)
        around = n_iter * (opcount.relocate_ops(self.c, self.k, h, w)
                           + opcount.leapfrog_ops(self.c, self.k, h, w, 0, False))
        self.ops = {self.kernel: traj_ops, "step": traj_ops + around}
        return window_s

    def n_steps(self, i: int) -> int:
        return ref.chees_steps(ref.halton2(i), float(self.traj), float(self.eps),
                               self.ccfg.max_leapfrog)

    def attempted_failed(self) -> tuple[int, int]:
        return self.flux.numel(), int((~torch.isfinite(self.flux)).sum())

    def ess(self) -> float:
        from ..ess import ess

        return ess(self.flux.double().cpu().numpy())

    def unadapt(self) -> None:
        """A planted fault, for the readings of accept_gap: the window runs
        at the warm-up's starting step size, trajectory length and unit
        mass, as if the adaptation had returned its state unchanged."""
        self.eps = torch.full((), self.ccfg.step_size, device=self.device)
        self.traj = torch.full((), self.ccfg.traj_length, device=self.device)
        self.inv_mass = torch.ones_like(self.inv_mass)

    def free(self) -> None:
        """Drop the program's objects the check does not read."""
        self.states = self.impl = self.grad_fn = self.reloc = None

    def check(self, control: bool = False) -> dict:
        """The first iteration of a seeded sample of the window's blocks, on a
        seeded sample of chains, against the float64 reference (and, with
        ``control``, the reference computed in bfloat16 in the program's
        place).

        At ChEES's adapted lengths (up to 1024 leapfrog steps) a trajectory
        can amplify rounding until its end point is another valid point:
        no float32 computation reproduces it, and the accept step then
        decides on another energy.  So a chain counts only where the
        reference computed in float32 ends its trajectory within delta / 10
        of the float64 one (a rule on the reference, not on the program);
        ``draws_off`` is the share of those chains whose draw, after the
        accept step and the relocate move, lies more than delta from the
        float64 reference's.

        The step size, mass and trajectory length are the program's own
        warm-up's; ``accept_gap`` holds the step size to the rule that
        adapted it: the float64 reference's mean acceptance probability over
        every compared chain lies near the dual averaging's target."""
        ck = self.tr["check"]
        dev, f64, delta = self.device, torch.float64, float(ck["delta"])
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.seed)
        rows = torch.randperm(self.c, generator=gen)[: int(ck["chains"])].to(dev)
        kept = self.sample.units()
        # every kept block's rows in one batch: the chains are independent,
        # and each row runs its own block's step count
        th0, th_prog, p0, u_acc, rd, nst = [], [], [], [], [], []
        for _, (state, th0_b, th_prog_b, i) in kept:
            p0_b, u_acc_b, rd_b = replay_draws(state, self.c, self.k,
                                               self.sc.height * self.sc.width, dev)
            th0.append(th0_b[rows])
            th_prog.append(th_prog_b[rows])
            p0.append(p0_b[rows])
            u_acc.append(u_acc_b[rows])
            rd.append([t[rows] for t in rd_b])
            nst.append(torch.full((len(rows),), self.n_steps(i), device=dev))
        th0, th_prog, p0, u_acc, nst = (torch.cat(t) for t in (th0, th_prog, p0, u_acc, nst))
        rd = tuple(torch.cat(t) for t in zip(*rd))
        reloc = self.tr["relocate"]

        def follow(dtype):
            return ref.chees_iteration(
                th0.to(dtype), self.sc, self.pr, self.image.to(dtype),
                torch.as_tensor(self.eps, device=dev).to(dtype), self.inv_mass.to(dtype), nst,
                self.ccfg.divergence_threshold, p0.to(dtype), u_acc.to(dtype),
                tuple(t.to(dtype) for t in rd), reloc)

        th_ref, a_ref, end_ref = follow(f64)
        n, acc = len(th0), float(a_ref.sum())
        m = torch.ones_like(th_ref[..., 0])
        cond = ~common.rows_off(follow(torch.float32)[2], m, end_ref, m, delta / 10)
        n_cond = int(cond.sum())
        off = {"program": int((common.rows_off(th_prog, m, th_ref, m, delta) & cond).sum())}
        gaps = common.gap_quantiles(th_prog[cond], th_ref[cond]) if n_cond else []
        if control:
            th_c = follow(common.LOW)[0]
            off["control"] = int((common.rows_off(th_c, m, th_ref, m, delta) & cond).sum())
        # no chain the reference can pin down: nothing was compared
        out = {"draws_off": off["program"] / n_cond if n_cond else float("nan"),
               "accept_gap": abs(acc / n - self.ccfg.target_accept) if n else float("nan")}
        self.check_notes = {"blocks": [b for b, _ in kept], "chains": n,
                            "chains_conditioned": n_cond, "mean_accept": acc / n if n else None,
                            "gap_q50_q90_q99_max": gaps}
        if control:
            # accept_gap reads the program's adaptation, which has no control
            self.check_notes["control"] = {
                "draws_off": off["control"] / n_cond if n_cond else float("nan")}
        return out
