"""sGrapp and sGrapp-x estimators (paper SS4.2/SS4.3, Algorithms 4 and 5).

Per closed window W_k the estimator is

    B-hat_k = B-hat_{k-1} + B_G^{W_k} + delta(k != 0) * |E_k| ** alpha

with B_G^{W_k} the exact in-window count (from the window executor) and
|E_k| the number of stream edges seen in [W_0^b, W_k^e).  sGrapp-x adapts
alpha by +-step per window while ground truth is available and the previous
window's relative error leaves the +-tol band (Algorithm 5 lines 18-21).

One float32 step function (:func:`_make_estimator_body`) serves replay
(:func:`sgrapp_estimate`, :func:`sgrapp_x_estimate`) and the online engine
(:class:`repro_torch.streams.engine.StreamingSGrapp`), through the one loop
:func:`estimator_run`, on the executor's device.  The same inputs therefore
give bit-identical estimates whether a stream is replayed or pushed.
Against the JAX reference the estimates agree within a relative tolerance
only: the recurrence raises ``|E_k|**alpha`` in float32, and torch's and
XLA's ``pow`` may differ in the last ulp.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device, same_device
from .executor import WindowExecutor
from .windows import WindowBatch

__all__ = [
    "window_exact_counts",
    "estimator_init",
    "estimator_step",
    "estimator_step_batched",
    "estimator_run",
    "sgrapp_estimate",
    "sgrapp_x_estimate",
    "SGrappResult",
    "run_sgrapp",
    "run_sgrapp_x",
    "mape",
]


# ---------------------------------------------------------------------------
# exact in-window counting over a padded window batch
# ---------------------------------------------------------------------------

def _executor_for(tier, executor, device, devices=None,
                  mesh=None) -> WindowExecutor:
    """The executor a one-shot entry point counts with: the caller's (whose tier
    and device must not conflict with the ones passed, and which owns its
    sharding: ``devices=`` / ``mesh=`` with it raise), or a new one."""
    if executor is not None:
        if tier is not None and executor.tier != tier:
            raise ValueError(
                f"tier={tier!r} conflicts with executor.tier={executor.tier!r}")
        if devices is not None or mesh is not None:
            raise ValueError(
                "devices=/mesh= conflict with executor=; configure the "
                "executor's sharding at construction instead")
        if device is not None and not same_device(device, executor.device):
            raise ValueError(
                f"device={device!r} conflicts with executor.device="
                f"{executor.device}")
        return executor
    return WindowExecutor(tier if tier is not None else "dense", device=device,
                          devices=devices, mesh=mesh)


def window_exact_counts(
    batch: WindowBatch,
    *,
    tier: str | None = None,
    executor: WindowExecutor | None = None,
    device=None,
    devices=None,
    mesh=None,
) -> torch.Tensor:
    """Exact butterfly count per window: ``[n_windows]`` float32 on the
    executor's device.  Pass an executor to reuse its staging buffers, or a
    ``tier`` name (default "dense") and ``device`` for one-shot use;
    ``devices=`` / ``mesh=`` shard the one-shot executor's window axis
    (counts equal bit for bit)."""
    ex = _executor_for(tier, executor, device, devices, mesh)
    return torch.as_tensor(ex.window_counts(batch), dtype=torch.float32,
                           device=ex.device)


# ---------------------------------------------------------------------------
# the shared per-window recurrence (Algorithms 4 and 5 share one body)
# ---------------------------------------------------------------------------

def _make_estimator_body(tol: float, step: float, device: torch.device):
    """The float32 step ``(carry, xs) -> (carry, B-hat_k)`` with carry
    ``(cumB, alpha, prev_err, prev_supervised)`` and xs ``(w_count, |E_k|,
    truth, has_truth, k)``, all 0-d tensors on ``device``.  Plain sGrapp is
    the case with no supervised window, where alpha never moves."""
    f32 = torch.float32
    tol_t = torch.tensor(tol, dtype=f32, device=device)
    step_t = torch.tensor(step, dtype=f32, device=device)
    zero = torch.zeros((), dtype=f32, device=device)
    one = torch.ones((), dtype=f32, device=device)

    def body(carry, xs):
        cum_b, alpha, prev_err, prev_supervised = carry
        w_count, e_k, truth, has_truth, k = xs
        # -- adapt alpha from the previous window's error (Alg. 5 lines 18-21)
        dec = prev_supervised & (prev_err > tol_t)
        inc = prev_supervised & (prev_err < -tol_t)
        alpha = alpha - step_t * dec.to(f32) + step_t * inc.to(f32)
        # -- estimate (Alg. 4 line 17 / Alg. 5 line 22)
        inter = torch.where(k > 0, e_k ** alpha, zero)
        cum_b = cum_b + w_count + inter
        # -- error for this window if ground truth exists (Alg. 5 lines 24-27)
        err = torch.where(has_truth,
                          (cum_b - truth) / torch.maximum(truth, one), zero)
        return (cum_b, alpha, err, has_truth), cum_b

    return body


def estimator_init(alpha0, *, device=None) -> tuple:
    """Initial carry ``(cumB, alpha, prev_err, prev_supervised)`` on
    ``device``."""
    dev = resolve_device(device)
    return (
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.as_tensor(alpha0, dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev),
    )


@functools.lru_cache(maxsize=None)
def estimator_step(tol: float = 0.05, step: float = 0.005, device=None):
    """The shared step for ``(tol, step)`` on ``device``, built once and
    reused for every window of every stream."""
    return _make_estimator_body(tol, step, resolve_device(device))


@functools.lru_cache(maxsize=None)
def estimator_step_batched(tol: float = 0.05, step: float = 0.005,
                           device=None):
    """The step of :func:`estimator_step` over N *independent* streams at
    once: ``(carry, xs, active) -> (carry, B-hat)`` with every carry leaf
    and xs lane a ``[N]`` tensor and ``active`` a bool ``[N]`` mask;
    inactive lanes pass their carry through unchanged.  For fleet-scale
    consumers that want one call per round: the multi-stream engine
    advances each tenant with the scalar :func:`estimator_step`, whose
    arithmetic is the single-stream engine's bit for bit (an elementwise
    ``pow`` over a vector may round differently from the scalar one)."""
    body = _make_estimator_body(tol, step, resolve_device(device))

    def masked(carry, xs, active):
        new_carry, est = body(carry, xs)
        return tuple(torch.where(active, n, o)
                     for n, o in zip(new_carry, carry)), est

    return masked


def estimator_run(step_fn, carry: tuple, window_counts, cum_edges, truths,
                  has_truth, k0: int = 0) -> tuple[tuple, torch.Tensor]:
    """Advance ``carry`` over consecutive windows ``k0, k0 + 1, ...``:
    ``window_counts`` / ``cum_edges`` / ``truths`` are cast to float32 and
    ``has_truth`` to bool, all moved to the carry's device at once, and
    ``step_fn`` runs per window in order.  Returns the new carry and the
    ``[n]`` float32 estimates on the device.  Replay runs all windows in one
    call, the engine one flush per call: the arithmetic is the same.  A
    tensor moves to the device as it is, without a trip through the host
    (so ``meta`` inputs trace)."""
    dev = carry[0].device
    wc = _on(window_counts, torch.float32, dev)
    ce = _on(cum_edges, torch.float32, dev)
    tr = _on(truths, torch.float32, dev)
    tm = _on(has_truth, torch.bool, dev)
    ks = torch.arange(k0, k0 + wc.shape[0], dtype=torch.int32, device=dev)
    est = []
    for n in range(wc.shape[0]):
        carry, e = step_fn(carry, (wc[n], ce[n], tr[n], tm[n], ks[n]))
        est.append(e)
    out = (torch.stack(est) if est
           else torch.zeros(0, dtype=torch.float32, device=dev))
    return carry, out


_NP_DTYPES = {torch.float32: np.float32, torch.bool: bool}


def _on(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, dtype)
    return torch.as_tensor(np.asarray(x, _NP_DTYPES[dtype]), device=dev)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Algorithm 4 -- sGrapp
# ---------------------------------------------------------------------------

def sgrapp_estimate(window_counts, cum_edges, alpha, *,
                    device=None) -> torch.Tensor:
    """Cumulative estimates B-hat_k for every window (the shared
    recurrence with supervision disabled), ``[n]`` float32 on ``device``."""
    wc = _host(window_counts)
    n = wc.shape[0]
    step_fn = estimator_step(0.05, 0.005, resolve_device(device))
    _, est = estimator_run(step_fn, estimator_init(alpha, device=device), wc,
                           _host(cum_edges), np.zeros(n, np.float32),
                           np.zeros(n, bool))
    return est


# ---------------------------------------------------------------------------
# Algorithm 5 -- sGrapp-x
# ---------------------------------------------------------------------------

def sgrapp_x_estimate(window_counts, cum_edges, alpha0, truths, truth_mask, *,
                      tol: float = 0.05, step: float = 0.005,
                      device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """sGrapp-x: returns (estimates ``[n]``, final alpha), float32 on
    ``device``.  ``truths`` / ``truth_mask`` give ground-truth cumulative
    counts for the supervised windows; alpha moves before window k's
    estimate using window k-1's error (Algorithm 5's ordering)."""
    step_fn = estimator_step(float(tol), float(step), resolve_device(device))
    (_, alpha_f, _, _), est = estimator_run(
        step_fn, estimator_init(alpha0, device=device), window_counts,
        cum_edges, truths, truth_mask)
    return est, alpha_f


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@dataclass
class SGrappResult:
    estimates: np.ndarray         # B-hat_k per window
    window_counts: np.ndarray     # exact in-window counts B_G^{W_k}
    cum_edges: np.ndarray         # |E_k|
    alpha_final: float
    truths: np.ndarray | None = None

    def relative_errors(self) -> np.ndarray:
        """Signed per-window errors over the prefix with ground truth."""
        if self.truths is None:
            raise ValueError("relative errors need truths")
        n = min(len(self.estimates), len(self.truths))
        t = np.maximum(np.abs(self.truths[:n]), 1.0)
        return (self.estimates[:n] - self.truths[:n]) / t

    def mape(self) -> float:
        return float(np.mean(np.abs(self.relative_errors())))


def run_sgrapp(
    batch: WindowBatch,
    alpha: float,
    *,
    truths: np.ndarray | None = None,
    tier: str | None = None,
    executor: WindowExecutor | None = None,
    device=None,
    devices=None,
    mesh=None,
) -> SGrappResult:
    """Algorithm 4 end-to-end: exact window counts through the executor's
    tier, then the estimator on the executor's (home) device.
    ``devices=`` / ``mesh=`` shard the window axis; the estimates are
    bit-identical across shard counts, because the counts are."""
    ex = _executor_for(tier, executor, device, devices, mesh)
    wc = ex.window_counts(batch).astype(np.float32)
    est = sgrapp_estimate(wc, batch.cum_sgrs, alpha, device=ex.device)
    return SGrappResult(_host(est), wc,
                        np.asarray(batch.cum_sgrs, dtype=np.float64),
                        float(alpha), truths)


def run_sgrapp_x(
    batch: WindowBatch,
    alpha0: float,
    truths: np.ndarray,
    *,
    x_percent: float = 100.0,
    tol: float = 0.05,
    step: float = 0.005,
    tier: str | None = None,
    executor: WindowExecutor | None = None,
    device=None,
    devices=None,
    mesh=None,
) -> SGrappResult:
    """Algorithm 5 end-to-end; ``x_percent`` is the share of windows with
    ground truth available (the paper's x); ``devices=`` / ``mesh=`` as in
    :func:`run_sgrapp`."""
    ex = _executor_for(tier, executor, device, devices, mesh)
    wc = ex.window_counts(batch).astype(np.float32)
    n = wc.shape[0]
    n_sup = int(round(n * x_percent / 100.0))
    full_truth = np.zeros(n, dtype=np.float64)
    mask = np.zeros(n, dtype=bool)
    m = min(n_sup, len(truths))
    full_truth[:m] = truths[:m]
    mask[:m] = True
    est, alpha_f = sgrapp_x_estimate(wc, batch.cum_sgrs, alpha0, full_truth,
                                     mask, tol=tol, step=step,
                                     device=ex.device)
    return SGrappResult(_host(est), wc,
                        np.asarray(batch.cum_sgrs, dtype=np.float64),
                        float(alpha_f), np.asarray(truths, dtype=np.float64))


def mape(estimates: np.ndarray, truths: np.ndarray) -> float:
    t = np.maximum(np.abs(np.asarray(truths, dtype=np.float64)), 1.0)
    return float(np.mean(np.abs(
        (np.asarray(estimates, dtype=np.float64) - truths) / t)))
