"""Trans-dimensional SMC: the window runs whole temperature steps through
the port's smc.make_smc_step from a fresh population at beta = 0 drawn from
``--seed``, the job a user runs.  With ``restart_at_beta1`` a job ends at
beta = 1 and the next starts from a fresh population inside the window (its
draw and initial likelihoods count there); without it the steps go on at
beta = 1 as the preset's posterior rounds do.

Every step's draws come from the port's own smc.draw_step on the
benchmark's generator, and each population from the port's smc.init_smc,
as a user's run_smc makes them.  The window keeps, for a seeded sample of
its steps (a reservoir, so its memory does not grow with its length), the
generator's state and the populations before and after; the check replays
smc.draw_step from that state, hands the same draws, cut to a seeded
sample of rows, to the reference, recomputes the likelihoods, tempering,
log Z and resampling in float64, and follows those rows through the sweeps
and mutations."""
from __future__ import annotations

import math
import time

import torch

from .. import opcount
from ..reference import steps as ref
from ..reference.model import log_likelihood
from . import common


def _rows(draws, rows) -> tuple:
    """A step's draws (the port's StepDraws) cut to ``rows``: the resampling
    uniform, each sweep's (selector, birth/death's, split/merge's), each
    mutation's (noise, step jitter, acceptance uniform)."""
    sweeps = [(sd.u_sel[rows], tuple(t[rows] for t in sd.bd), tuple(t[rows] for t in sd.sm))
              for sd in draws.sweeps]
    return draws.u_res, sweeps, [tuple(t[rows] for t in m) for m in draws.mutation]


class Head:
    name = "smc"

    def __init__(self, cell: dict, seed: int, device: torch.device, overrides: dict | None = None):
        self.cfg = cell["config_data"]
        self.tr = {**cell["traffic_data"], **(overrides or {})}
        self.limits = cell["limits"]
        self.seed, self.device = seed, device
        self.sc, self.pr = common.scene_and_prior(self.cfg)
        self.k = common.capacity(self.cfg, self.tr)
        self.p = int(self.tr["n_particles"])
        self.counters: dict = {}
        self.ops: dict = {}

    def setup(self) -> None:
        from starcat_torch import dispatch, smc
        from starcat_torch.potential import PriorSpec
        from starcat_torch.scene import SceneSpec
        from starcat_torch.transdim import TransDimConfig

        dev, tr = self.device, self.tr
        _, image = common.mock_scene(self.cfg)
        self.image = image.to(dev)
        self.spec, self.prior = SceneSpec(*self.sc), PriorSpec(*self.pr)
        td = tr["transdim"]
        self.scfg = smc.SMCConfig(
            n_particles=self.p, ess_target_frac=tr["ess_target_frac"], mutation=tr["mutation"],
            n_mutation_steps=tr["n_mutation_steps"], n_leapfrog=tr["n_leapfrog"],
            fixed_point_iters=tr["fixed_point_iters"],
            n_transdim_sweeps=tr["n_transdim_sweeps"], step_size0=tr["step_size0"],
            target_accept=tr["target_accept"], divergence_threshold=tr["divergence_threshold"],
            mutation_chunk=tr["mutation_chunk"],
            transdim=TransDimConfig(**{k: td[k] for k in TransDimConfig._fields}))
        self.step = smc.make_smc_step(self.spec, self.image, self.prior, self.k, self.scfg,
                                      fused=True)
        self.kernel = dispatch.trajectory_kernel("smc", smc.MUTATIONS[tr["mutation"]],
                                                 self.spec, self.k)
        # steps of a population from the warm-up generator: every shape built,
        # and, with warmup_job, a whole job to beta = 1 and the next one's
        # first step, so the allocator has held every block the window takes
        gw = torch.Generator(device=dev)
        gw.manual_seed(int(tr["warmup_seed"]))
        s = self._advance(self._fresh(gw), gw)
        if tr["warmup_job"]:
            while float(s.beta) < 1.0:
                s = self._advance(s, gw)
            self._advance(self._fresh(gw), gw)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.seed)
        self.state = self._fresh(self.gen)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fresh(self, g):
        from starcat_torch import smc

        return smc.init_smc(g, self.spec, self.image, self.prior, self.k, self.scfg)

    def _draws(self, g):
        from starcat_torch import smc

        return smc.draw_step(g, self.p, self.k, self.spec, self.prior, self.scfg, self.device)

    def _advance(self, s, g):
        return self.step(s, self._draws(g))

    def window(self, seconds: float, span) -> float:
        # (generator state, state before, state after) of a seeded sample of steps
        self.sample = common.Sample(self.seed, int(self.tr["check"]["steps"]) - 1)
        s = self.state
        steps, jobs, live, live_sq, bad = 0, 0, 0.0, 0.0, 0
        slow = []   # (seconds, step, steps since the job started) of the slowest steps
        t0 = t_step = time.perf_counter()
        in_job = 0
        while True:
            state = self.gen.get_state()
            with span("bench.smc_step"):
                s_new = self._advance(s, self.gen)
            with span("bench.sync"):
                beta, n_live, n_sq, n_bad = torch.stack([
                    s_new.beta.double(), s_new.mask.sum().double(),
                    (s_new.mask.sum(-1) ** 2).sum().double(),
                    (~torch.isfinite(s_new.theta)).any(-1).any(-1).sum().double()]).tolist()
            self.sample.offer(steps, lambda: (state, s, s_new))  # noqa: B023
            now = time.perf_counter()
            slow = sorted(slow + [(now - t_step, steps, in_job)], reverse=True)[:3]
            t_step, in_job = now, in_job + 1
            steps += 1
            live += n_live
            live_sq += n_sq
            bad += int(n_bad)
            s = s_new
            if time.perf_counter() - t0 >= seconds:
                break
            if beta >= 1.0 and self.tr["restart_at_beta1"]:
                with span("bench.new_population"):
                    s = self._fresh(self.gen)
                jobs += 1
                in_job = 0
        window_s = time.perf_counter() - t0
        self.state = s
        self.counters = {"steps": steps, "particle_steps": self.p * steps, "jobs": jobs,
                         "failed": bad, "window_s": window_s, "slowest_steps": slow}
        h, w, tr = self.sc.height, self.sc.width, self.tr
        n_mut, nl, fpi = int(tr["n_mutation_steps"]), int(tr["n_leapfrog"]), int(tr["fixed_point_iters"])
        if tr["mutation"].startswith("rhmc_diag"):
            mut = n_mut * opcount.rhmc_diag_ops(1, live, h, w, nl, fpi)
        else:
            mut = n_mut * opcount.rhmc_full_ops_live(live, live_sq, h, w, nl, fpi)
        sweeps = (int(tr["n_transdim_sweeps"]) * opcount.sweep_renders(tr["transdim"]["birth_proposal"])
                  * opcount.render_ops(live, h, w))
        self.ops = {self.kernel: mut, "step": mut + sweeps + opcount.render_ops(live, h, w)}
        return window_s

    def attempted_failed(self) -> tuple[int, int]:
        return self.counters["particle_steps"], self.counters["failed"]

    def free(self) -> None:
        self.step = self.state = None

    def check(self, control: bool = False) -> dict:
        """A seeded sample of the window's steps against the float64
        reference, which follows the program's own tempering step (the
        bisection's root is only as exact as the float32 ESS it compares, so
        beta is held by the rule itself: tempering_gap); ``control`` also
        runs the reference in bfloat16 in the program's place."""
        ck, tr = self.tr["check"], self.tr
        dev, f64 = self.device, torch.float64
        frac = tr["ess_target_frac"]
        kept = self.sample.units()
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.seed)
        rows = torch.randperm(self.p, generator=gen)[: int(ck["rows"])].to(dev)
        mut = {"metric": "diag" if tr["mutation"].startswith("rhmc_diag") else "full",
               "n_leapfrog": int(tr["n_leapfrog"]), "fixed_point_iters": int(tr["fixed_point_iters"]),
               "jitter": float(tr["jitter"]), "solver_tol": float(tr["solver_tol"])}
        sides = ["program"] + (["control"] if control else [])
        res = {s: {"particles_off": 0, "tempering_gap": 0.0, "log_z_gap": 0.0} for s in sides}
        gaps = []
        chunk = int(ck["chunk"])
        for _, (state, s0, s1) in kept:
            g = torch.Generator(device=dev)
            g.set_state(state)
            u_res, sweeps, mutation = _rows(self._draws(g), rows)

            def loglik(dtype):
                img = self.image.to(dtype)
                return torch.cat([log_likelihood(s0.theta[a:a + chunk].to(dtype),
                                                     s0.mask[a:a + chunk].to(dtype), self.sc, img)
                                  for a in range(0, self.p, chunk)])

            def follow(dtype, ll, db=None):
                """(db, log Z', rows' theta and mask) of the step at ``dtype``."""
                beta0 = s0.beta.to(dtype)
                db, log_z, idx = ref.tempering(ll, beta0, s0.log_z.to(dtype), u_res.to(dtype),
                                               frac, db)
                par, img, outs = idx[rows], self.image.to(dtype), []
                for a in range(0, len(rows), chunk):
                    sl = slice(a, a + chunk)

                    def cut(t):
                        return t[sl].to(dtype) if t.is_floating_point() else t[sl]

                    sw = [(cut(u), tuple(cut(t) for t in bd), tuple(cut(t) for t in sm))
                          for u, bd, sm in sweeps]
                    mu = [tuple(cut(t) for t in m) for m in mutation]
                    outs.append(ref.smc_follow(
                        s0.theta[par[sl]].to(dtype), s0.mask[par[sl]].to(dtype), ll[par[sl]],
                        beta0 + db, s0.eps.to(dtype), sw, mu, self.sc, self.pr, img,
                        tr["transdim"], mut))
                return db, log_z, torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

            ll = loglik(f64)
            db_p = s1.beta.to(f64) - s0.beta.to(f64)
            _, z_ref, th_ref, m_ref = follow(f64, ll, db_p)
            for side in sides:
                if side == "program":
                    db, z, th, m = db_p, s1.log_z, s1.theta[rows], s1.mask[rows]
                else:
                    db, z, th, m = follow(common.LOW, loglik(common.LOW))
                    db = db.to(f64)
                z_at = ref.tempering(ll, s0.beta.to(f64), s0.log_z.to(f64), u_res.to(f64), frac,
                                     db)[1]
                r = res[side]
                r["particles_off"] += int(common.rows_off(th, m, th_ref, m_ref, ck["delta"]).sum())
                r["tempering_gap"] = max(r["tempering_gap"], ref.tempering_gap(
                    db, ll, s0.beta.to(f64), frac))
                r["log_z_gap"] = max(r["log_z_gap"], _gap(z, z_at))
            gaps.append(common.gap_quantiles(s1.theta[rows], th_ref))
        n = len(kept) * len(rows)
        for r in res.values():
            r["particles_off"] /= n
        self.check_notes = {"steps": [i for i, _ in kept], "rows_compared": n,
                            "gap_q50_q90_q99_max": gaps}
        if control:
            self.check_notes["control"] = res["control"]
        return res["program"]


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    d = abs(float(a.double()) - float(b.double()))
    return d if math.isfinite(d) else math.inf
