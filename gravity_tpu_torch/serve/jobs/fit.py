"""The ``fit`` job class: inverse problems through the differentiable
rollout, served.

Counterpart of ``gravity_tpu/serve/jobs/fit.py``: recover initial
velocities (launch vectors, orbital elements as velocity degrees of
freedom) from observed trajectory points. One fit job is a gradient
descent or Adam loop; B fit jobs share one batch of a key, as the
engine batches integrations (the same bucket padding, per-slot budgets,
one build per extended BatchKey).

Where the JAX package scans iterations inside one jitted program and
vmaps it over the slots, a round here is a Python loop of iterations
over the whole batch: each is one batched forward rollout through the
key's batched kernel (a hand-written kernel's batched launch for
``pallas``, ``pallas-mxu`` and ``nlist``, each step's force evaluation
saved for the backward by ``ops/forces.DenseVJP``), one
``torch.autograd.grad`` with respect to the velocities (the kernels'
backward is the JAX package's dense VJP: plain PyTorch, no kernel), and
the optimizer update with the JAX constants and the same ``take = i <
remaining`` select, all device tensors. A round reads the host once: the
finite flags.

Budget: fit jobs are ITERATION-budgeted; ``slice_units`` turns the
scheduler's ``slice_steps`` into ``max(1, slice_steps // rollout)``
iterations, so a fit round costs about what an integrate round costs.

Loss: over the observation steps t_k, ``sum_i w_i |(x_i(t_k) - obs_{k,i})
/ scale|^2``, the observed particles chosen by ``params["particles"]``.
The served round and :func:`fit_solo` run one program
(:func:`fit_program`): served-vs-solo parity is structural.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ...interop import to_numpy
from ...state import ParticleState
from .registry import (
    JobClass,
    JobValidationError,
    params_state,
    register,
    validate_params_state,
)

OPTIMIZERS = ("adam", "gd")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class FitBatch:
    """Device slot tensors of one fit BatchKey; the budget bookkeeping
    (``dt``, ``remaining``, ``iter_done``, ``n_real``) on the host, as
    :class:`~gravity_tpu_torch.serve.engine.EnsembleBatch` keeps it."""

    key: object
    pos0: torch.Tensor     # (B, n, 3) initial positions, fixed
    v: torch.Tensor        # (B, n, 3) the velocity parameters
    masses: torch.Tensor   # (B, n)
    free: torch.Tensor     # (B, n) 1 where v takes gradient updates
    obs_pos: torch.Tensor  # (B, K, n, 3)
    obs_w: torch.Tensor    # (B, K, n) observation weights (0 unobserved)
    obs_step: torch.Tensor  # (B, K) int64, -1 for none
    scale: torch.Tensor    # (B,) loss normalization
    lr: torch.Tensor       # (B,)
    m_adam: torch.Tensor   # (B, n, 3)
    v_adam: torch.Tensor   # (B, n, 3)
    loss: torch.Tensor     # (B,)
    dt: np.ndarray         # (B,)
    remaining: np.ndarray  # (B,) int64 iterations left
    iter_done: np.ndarray  # (B,) int64 the Adam step counter's base
    n_real: np.ndarray     # (B,) int32

    @property
    def slots(self) -> int:
        return self.pos0.shape[0]


def fit_program(kernel, integrator: str, rollout: int, optimizer: str):
    """The fit program over B systems: ``(pos0, v, masses, free, obs_pos,
    obs_w, obs_step, scale, lr, slot_args, m_a, v_a, loss, iter0, *,
    n_iters, all_take, probe=None) -> (v, m_a, v_a, loss, finite)``.

    ``kernel`` is a batched ``(B, M, 3) x (B, K, 3) x (B, K) -> (B, M,
    3)``; ``slot_args`` (B, 3) float64 each slot's dt, budget and real
    count (``engine.slot_args``); ``iter0`` (B,) float64 the Adam
    counter's base; ``all_take`` (host) the iterations in which every
    slot takes; ``probe`` a FirstCall entered around the first
    iteration. ONE definition for the served rounds and :func:`fit_solo`
    (the JAX package's ``_system_fn``)."""
    from ...ops.integrators import make_step_fn
    from ..engine import real_lanes_finite

    def run(pos0, v, masses, free, obs_pos, obs_w, obs_step, scale, lr,
            slot_args, m_a, v_a, loss, iter0, *, n_iters, all_take,
            probe=None):
        dtype = pos0.dtype
        dt = slot_args[:, 0].reshape(-1, 1, 1)
        remaining, n_real = slot_args[:, 1], slot_args[:, 2]
        step = make_step_fn(integrator, lambda p: kernel(p, p, masses), dt)
        scale4 = scale.reshape(-1, 1, 1, 1)
        free3 = free[..., None]

        def value_and_grad(v_c):
            vp = v_c.detach().requires_grad_(True)
            with torch.enable_grad():
                st = ParticleState(pos0, vp, masses)
                a = kernel(pos0, pos0, masses)
                costs = []
                for i in range(rollout):
                    st, a = step(st, a)
                    # An observation hits at step i + 1 ("the state after
                    # i + 1 steps").
                    hit = (obs_step == i + 1)[:, :, None, None]
                    d = (st.positions[:, None] - obs_pos) / scale4
                    costs.append(torch.where(
                        hit, obs_w[..., None] * d * d, 0.0).sum(dim=(1, 2, 3)))
                val = torch.stack(costs).sum(dim=0)
                (g,) = torch.autograd.grad(val.sum(), vp)
            return val.detach(), g

        b1 = torch.full((), ADAM_B1, dtype=dtype, device=pos0.device)
        b2 = torch.full((), ADAM_B2, dtype=dtype, device=pos0.device)
        for i in range(n_iters):
            if i == 0 and probe is not None:
                with probe:
                    val, g = value_and_grad(v)
            else:
                val, g = value_and_grad(v)
            g = g * free3
            if optimizer == "adam":
                t = (iter0 + (i + 1)).to(dtype).reshape(-1, 1, 1)
                m_n = ADAM_B1 * m_a + (1.0 - ADAM_B1) * g
                v_n2 = ADAM_B2 * v_a + (1.0 - ADAM_B2) * g * g
                m_hat = m_n / (1.0 - torch.pow(b1, t))
                v_hat = v_n2 / (1.0 - torch.pow(b2, t))
                upd = lr.reshape(-1, 1, 1) * m_hat / (torch.sqrt(v_hat)
                                                      + ADAM_EPS)
            else:
                m_n, v_n2 = m_a, v_a
                upd = lr.reshape(-1, 1, 1) * g
            v_new = v - upd * free3
            if all_take[i]:
                v, m_a, v_a, loss = v_new, m_n, v_n2, val
                continue
            take = i < remaining
            t3 = take.reshape(-1, 1, 1)
            v = torch.where(t3, v_new, v)
            m_a = torch.where(t3, m_n, m_a)
            v_a = torch.where(t3, v_n2, v_a)
            loss = torch.where(take, val, loss)
        fin = real_lanes_finite(n_real, v) & torch.isfinite(loss)
        # A non-finite lane rolls nothing back: the scheduler fails its
        # slot; the loss and v of a diverged fit are not a result.
        return v, m_a, v_a, loss, fin

    return run


def _key_params(key) -> dict:
    return dict(key.extra)


def _observation_arrays(params: dict, n: int, k_obs: int):
    """(obs_pos (K, n, 3), obs_w (K, n), obs_step (K,), free (n,)) host
    arrays of a validated payload at n bodies (padding unobserved)."""
    obs = params["observations"]
    particles = params["particles"]
    obs_pos = np.zeros((k_obs, n, 3))
    obs_w = np.zeros((k_obs, n))
    obs_step = np.full((k_obs,), -1, np.int64)
    pos_arr = np.asarray(obs["positions"], dtype=np.float64)
    for k, s in enumerate(obs["steps"]):
        obs_step[k] = s
        obs_pos[k, particles] = pos_arr[k]
        obs_w[k, particles] = 1.0
    free = np.zeros((n,))
    free[particles] = 1.0
    return obs_pos, obs_w, obs_step, free


class FitJob(JobClass):
    name = "fit"
    units = "iters"
    # The ledger and sentinel gate: fit lanes carry the optimizer's moving
    # guess, not an integrating trajectory.
    conserves = False

    # --- admission ---

    def validate(self, config, params):
        params = dict(params or {})
        unknown = set(params) - {
            "observations", "particles", "iters", "lr", "optimizer",
            "scale", "guess_velocities", "state",
        }
        if unknown:
            raise JobValidationError(
                f"fit: unknown params {sorted(unknown)}")
        obs = params.get("observations")
        if not isinstance(obs, dict) or "steps" not in obs \
                or "positions" not in obs:
            raise JobValidationError(
                "fit requires params.observations = {steps: [...], "
                "positions: [[...]]} — there is nothing to fit to")
        validate_params_state(config, params)
        try:
            steps = [int(s) for s in obs["steps"]]
        except (TypeError, ValueError) as e:
            raise JobValidationError(
                f"fit: observations.steps not integers: {e}") from e
        if not steps:
            raise JobValidationError("fit: observations.steps is empty")
        if any(s < 1 or s > config.steps for s in steps):
            raise JobValidationError(
                f"fit: observation steps {steps} outside the rollout "
                f"[1, {config.steps}]")
        particles = params.get("particles")
        if particles is None:
            particles = list(range(config.n))
        try:
            particles = sorted({int(p) for p in particles})
        except (TypeError, ValueError) as e:
            raise JobValidationError(
                f"fit: particles not integers: {e}") from e
        if not particles or particles[0] < 0 \
                or particles[-1] >= config.n:
            raise JobValidationError(
                f"fit: particles must be non-empty indices in "
                f"[0, {config.n})")
        try:
            pos = np.asarray(obs["positions"], dtype=np.float64)
        except (TypeError, ValueError) as e:
            raise JobValidationError(
                f"fit: observations.positions not numeric: {e}") from e
        want = (len(steps), len(particles), 3)
        if pos.shape != want:
            raise JobValidationError(
                f"fit: observations.positions shape {pos.shape} != "
                f"(len(steps), len(particles), 3) = {want}")
        try:
            iters = int(params.get("iters", 100))
        except (TypeError, ValueError) as e:
            raise JobValidationError(f"fit: bad iters: {e}") from e
        if iters < 1:
            raise JobValidationError("fit: iters must be >= 1")
        try:
            lr = float(params.get("lr", 1e-2))
            scale = float(params.get("scale", 1.0))
        except (TypeError, ValueError) as e:
            raise JobValidationError(f"fit: bad lr/scale: {e}") from e
        if lr <= 0 or scale <= 0:
            raise JobValidationError("fit: lr and scale must be > 0")
        optimizer = params.get("optimizer", "adam")
        if optimizer not in OPTIMIZERS:
            raise JobValidationError(
                f"fit: optimizer {optimizer!r} not in {OPTIMIZERS}")
        guess = params.get("guess_velocities")
        if guess is not None:
            try:
                guess = np.asarray(guess, dtype=np.float64)
            except (TypeError, ValueError) as e:
                raise JobValidationError(
                    f"fit: guess_velocities not numeric: {e}") from e
            if guess.shape != (config.n, 3):
                raise JobValidationError(
                    f"fit: guess_velocities shape {guess.shape} != "
                    f"({config.n}, 3)")
            params["guess_velocities"] = guess.tolist()
        params["observations"] = {"steps": steps, "positions": pos.tolist()}
        params["particles"] = particles
        params["iters"] = iters
        params["lr"] = lr
        params["scale"] = scale
        params["optimizer"] = optimizer
        return params

    def key_extra(self, config, params) -> tuple:
        # Static program parameters: jobs that differ in the rollout
        # length, the observation count or the optimizer cannot share a
        # program.
        return (
            ("rollout", int(config.steps)),
            ("obs", len(params["observations"]["steps"])),
            ("opt", params["optimizer"]),
        )

    def budget(self, job) -> int:
        return int(job.params["iters"])

    def slice_units(self, key, slice_steps: int) -> int:
        return max(1, slice_steps // max(1, _key_params(key)["rollout"]))

    def pairs_per_unit(self, job) -> float:
        # One iteration = one forward rollout (the backward, ~2x more, is
        # not counted: the metric is dense-equivalent throughput).
        from ...utils.timing import pairs_per_step

        return pairs_per_step(job.config.n) * job.config.steps

    # --- the program family ---

    def build_round_fn(self, engine, key):
        from ...utils import faults
        from ..engine import _resolved

        faults.check_backend(key.backend, _resolved(key.backend))
        kp = _key_params(key)
        return fit_program(engine.counted_kernel(key), key.integrator,
                           kp["rollout"], kp["opt"])

    def new_batch(self, engine, key):
        from ...simulation import resolve_dtype

        b, n = key.slots, key.bucket_n
        k_obs = _key_params(key)["obs"]
        z = dict(dtype=resolve_dtype(key.dtype), device=engine.device)
        return FitBatch(
            key=key, pos0=torch.zeros((b, n, 3), **z),
            v=torch.zeros((b, n, 3), **z), masses=torch.zeros((b, n), **z),
            free=torch.zeros((b, n), **z),
            obs_pos=torch.zeros((b, k_obs, n, 3), **z),
            obs_w=torch.zeros((b, k_obs, n), **z),
            obs_step=torch.full((b, k_obs), -1, dtype=torch.int64,
                                device=engine.device),
            scale=torch.ones((b,), **z), lr=torch.zeros((b,), **z),
            m_adam=torch.zeros((b, n, 3), **z),
            v_adam=torch.zeros((b, n, 3), **z), loss=torch.zeros((b,), **z),
            dt=np.zeros((b,), np.float64),
            remaining=np.zeros((b,), np.int64),
            iter_done=np.zeros((b,), np.int64),
            n_real=np.zeros((b,), np.int32),
        )

    def load_slot(self, engine, batch, slot, state, *, dt, steps, job):
        from ...simulation import resolve_dtype

        key = batch.key
        dtype = resolve_dtype(key.dtype)
        dev = engine.device
        params = job.params
        extra = job.extra_state or {}
        # The velocity parameters: a resume snapshot's, else an explicit
        # guess, else the config's own initial velocities.
        if "v" in extra:
            vel = torch.as_tensor(np.asarray(extra["v"]))
        elif params.get("guess_velocities") is not None:
            vel = torch.as_tensor(np.asarray(params["guess_velocities"]))
        else:
            vel = state.velocities
        st = ParticleState(state.positions, vel, state.masses)
        padded, _ = st.astype(dtype).to(dev).pad_to(key.bucket_n)
        k_obs = _key_params(key)["obs"]
        obs_pos, obs_w, obs_step, free = _observation_arrays(
            params, key.bucket_n, k_obs)
        z3 = np.zeros((key.bucket_n, 3))

        def moment(name):
            m = np.asarray(extra.get(name, z3), dtype=np.float64)
            return np.pad(m, ((0, key.bucket_n - m.shape[0]), (0, 0)))

        def put(t, value):
            t = t.clone()
            t[slot] = torch.as_tensor(value, dtype=t.dtype).to(dev)
            return t

        dt_h, rem, it0, nr = (batch.dt.copy(), batch.remaining.copy(),
                              batch.iter_done.copy(), batch.n_real.copy())
        dt_h[slot], rem[slot], nr[slot] = dt, steps, state.n
        it0[slot] = int(extra.get("iter_done", job.steps_done))
        return dataclasses.replace(
            batch,
            pos0=put(batch.pos0, padded.positions),
            v=put(batch.v, padded.velocities),
            masses=put(batch.masses, padded.masses),
            free=put(batch.free, free), obs_pos=put(batch.obs_pos, obs_pos),
            obs_w=put(batch.obs_w, obs_w),
            obs_step=put(batch.obs_step, obs_step),
            scale=put(batch.scale, float(params["scale"])),
            lr=put(batch.lr, float(params["lr"])),
            m_adam=put(batch.m_adam, moment("m_adam")),
            v_adam=put(batch.v_adam, moment("v_adam")),
            loss=put(batch.loss, float(extra.get("loss", 0.0))),
            dt=dt_h, remaining=rem, iter_done=it0, n_real=nr,
        )

    def clear_slot(self, engine, batch, slot):
        rem, nr = batch.remaining.copy(), batch.n_real.copy()
        rem[slot], nr[slot] = 0, 0
        masses, free = batch.masses.clone(), batch.free.clone()
        masses[slot], free[slot] = 0, 0
        return dataclasses.replace(batch, masses=masses, free=free,
                                   remaining=rem, n_real=nr)

    def slot_snapshot(self, engine, batch, slot):
        n = int(batch.n_real[slot])
        state = ParticleState(
            positions=batch.pos0[slot, :n].clone(),
            velocities=batch.v[slot, :n].clone(),
            masses=batch.masses[slot, :n].clone(),
        )
        extra = {
            "v": to_numpy(batch.v[slot, :n]),
            "m_adam": to_numpy(batch.m_adam[slot, :n]),
            "v_adam": to_numpy(batch.v_adam[slot, :n]),
            "loss": float(batch.loss[slot]),
            "iter_done": int(batch.iter_done[slot]),
        }
        return state, extra

    def run_slice(self, engine, batch, slice_steps):
        from ..engine import SliceResult, account_slice, slot_args

        engine._check_thread()
        key = batch.key
        n_iters = self.slice_units(key, slice_steps)
        t0 = time.perf_counter()
        fn = engine.round_fn(key)
        probe = engine.first_round_probe(key, (
            batch.pos0, batch.v, batch.masses, batch.free, batch.obs_pos,
            batch.obs_w, batch.m_adam, batch.v_adam))
        args, all_take = slot_args(batch.dt, batch.remaining, batch.n_real,
                                   n_iters, engine.device)
        iter0 = torch.from_numpy(batch.iter_done.astype(np.float64)).to(
            engine.device)
        v, m_a, v_a, loss, finite = fn(
            batch.pos0, batch.v, batch.masses, batch.free, batch.obs_pos,
            batch.obs_w, batch.obs_step, batch.scale, batch.lr, args,
            batch.m_adam, batch.v_adam, batch.loss, iter0,
            n_iters=n_iters, all_take=all_take, probe=probe)
        finite_host = finite.cpu().numpy()
        engine.host_reads["finite"] += 1
        if probe is not None:
            engine._record_first_round(key, probe, time.perf_counter() - t0)
        advanced, remaining, finite_np = account_slice(
            batch.remaining, batch.n_real, n_iters, finite_host)
        new_batch = dataclasses.replace(
            batch, v=v, m_adam=m_a, v_adam=v_a, loss=loss,
            remaining=remaining, iter_done=batch.iter_done + advanced)
        return new_batch, SliceResult(advanced=advanced, finite=finite_np)

    def finalize(self, job, state, extra):
        loss = float(extra.get("loss", np.nan))
        iters = int(extra.get("iter_done", job.steps_done))
        pos, vel, m = (to_numpy(t) for t in (
            state.positions, state.velocities, state.masses))
        arrays = {
            "positions": pos, "velocities": vel, "masses": m,
            "loss": np.asarray([loss]), "iters_done": np.asarray([iters]),
        }
        return arrays, {"loss": loss, "iters_done": iters}


def fit_solo(config, params, *, device=None) -> dict:
    """The solo reference: :func:`fit_program` on one system at n,
    unpadded, run once (the card unless ``device`` asks for the CPU) —
    the parity oracle of a served fit (<= 1e-5) and the library entry of
    the orbit-fit example."""
    from ...simulation import make_initial_state, resolve_dtype
    from ...utils.platform import resolve_device
    from ..engine import solo_batched_kernel

    dev = resolve_device(device)
    fit = FitJob()
    params = fit.validate(config, params)
    dtype = resolve_dtype(config.dtype)
    base = params_state(params) or make_initial_state(config, device="cpu")
    n = base.n
    if params.get("guess_velocities") is not None:
        vel = torch.as_tensor(np.asarray(params["guess_velocities"]))
    else:
        vel = base.velocities
    st = ParticleState(base.positions, vel, base.masses).astype(dtype).to(dev)
    k_obs = len(params["observations"]["steps"])
    obs_pos, obs_w, obs_step, free = _observation_arrays(params, n, k_obs)
    iters = int(params["iters"])
    program = fit_program(solo_batched_kernel(config), config.integrator,
                          int(config.steps), params["optimizer"])

    def one(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(dev)[None]

    z3 = torch.zeros((1, n, 3), dtype=dtype, device=dev)
    args = torch.tensor([[float(config.dt), float(iters), float(n)]],
                        dtype=torch.float64).to(dev)
    v, _, _, loss, fin = program(
        st.positions[None], st.velocities[None], st.masses[None], one(free),
        one(obs_pos), one(obs_w), one(obs_step, torch.int64),
        one(float(params["scale"])), one(float(params["lr"])), args, z3, z3,
        torch.zeros((1,), dtype=dtype, device=dev),
        torch.zeros((1,), dtype=torch.float64, device=dev),
        n_iters=iters, all_take=np.ones(iters, bool))
    return {
        "positions": to_numpy(st.positions),
        "velocities": to_numpy(v[0]),
        "masses": to_numpy(st.masses),
        "loss": float(loss[0]),
        "iters_done": iters,
        "finite": bool(fin[0]),
    }


register(FitJob())
