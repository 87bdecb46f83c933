"""L-BFGS (counterpart of ``paddle_tpu/optimizer/lbfgs.py``).

Host-driven quasi-Newton, as in the reference: the two-loop recursion
runs in float64 numpy over a bounded (s, y) history of flattened
parameter deltas, and every evaluation calls the user's closure, which
runs the forward and backward on the parameters' device (eagerly; a
closure is arbitrary Python). ``step(closure)`` may evaluate the closure
several times: the Armijo backtracking search, or ``line_search_fn=
"strong_wolfe"`` (bracketing, then bisection). The arithmetic is the
reference's line for line, so a card run and a CPU run differ only by
what the closure returns.

Over more than one rank (``fleet``'s mp, dp, ZeRO or expert layouts)
each rank's flat vectors hold its parameters' local pieces, and every
quantity the reference reads of the whole model is global: each dot
product sums the pieces' partial dots over the axes that cut them
(``shard.regions``; a part replicated over an axis counts once), one
float64 all-reduce per set of axes, and each max-abs is a MAX over
every rank. The loss is MAX-reduced as well, so that every rank takes
the same branch of the searches (a rank that left a loop alone would
hang the others in the next collective).
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


class _Global:
    """The global reductions over this process's ranks for the flat
    vectors of ``params``: ``dot(a, b)``, ``max_abs(v)`` and ``same``
    (the MAX of a scalar every rank holds)."""

    def __init__(self, params):
        import torch.distributed as dist

        from ..distributed import env as env_mod
        from ..distributed import shard

        env = env_mod.ensure_env()
        self.world = env.group(env_mod.AXIS_ORDER)
        by_axes, off = {}, 0
        for p in params:
            lay = getattr(p, "_dist_layout", None)
            idx = torch.arange(off, off + p.numel()).reshape(p.shape)
            parts = [(None, idx, ())] if lay is None \
                else shard.regions(idx, lay)
            for _, part, axes in parts:
                key = env_mod._canon(axes) if axes else ()
                by_axes.setdefault(key, []).append(part.reshape(-1))
            off += p.numel()
        # the largest bucket's partial is the whole local dot less the
        # others' (one BLAS dot over the vector, gathers of the rest only)
        big = max(by_axes, key=lambda k: sum(t.numel() for t in by_axes[k]))
        self.big = env.group(big) if big else None
        self.buckets = [(env.group(k) if k else None, torch.cat(v).numpy())
                        for k, v in by_axes.items() if k != big]
        # NCCL reduces CUDA tensors, gloo CPU ones
        self.device = "cpu" if dist.get_backend(self.world[1]) == "gloo" \
            else "cuda"

    def _reduce(self, value, group, op=None):
        """``value`` reduced over ``group`` (a SUM; unchanged without a
        group of more than one rank)."""
        import torch.distributed as dist

        from ..distributed import _comm

        if group is None or len(group[0]) == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        _comm.all_reduce(t, group, op or dist.ReduceOp.SUM)
        return float(t[0])

    def dot(self, a, b):
        rest, total = float(a @ b), 0.0
        for group, idx in self.buckets:
            part = float(a[idx] @ b[idx])
            rest -= part
            total += self._reduce(part, group)
        return total + self._reduce(rest, self.big)

    def max_abs(self, v):
        import torch.distributed as dist

        return self._reduce(float(np.abs(v).max(initial=0.0)), self.world,
                            dist.ReduceOp.MAX)

    def same(self, loss):
        import torch.distributed as dist

        return self._reduce(loss, self.world, dist.ReduceOp.MAX)


class _Local:
    """One rank's reductions: the reference's own."""

    @staticmethod
    def dot(a, b):
        return float(a @ b)

    @staticmethod
    def max_abs(v):
        return float(np.abs(v).max(initial=0.0))

    @staticmethod
    def same(loss):
        return loss



class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip)
        self.max_iter = int(max_iter)
        self.max_eval = int(max_eval) if max_eval else self.max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = int(history_size)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or 'strong_wolfe'")
        self.line_search_fn = line_search_fn
        self._s: list[np.ndarray] = []
        self._y: list[np.ndarray] = []
        self._prev_flat = None
        self._prev_grad = None
        self._red = None

    def _reductions(self):
        """:class:`_Global` over more than one rank, else :class:`_Local`
        (made at the first step, after ``fleet`` laid the parameters
        out)."""
        if self._red is None:
            from ..distributed import env as env_mod

            env = env_mod.get_env()
            self._red = _Global(self._parameter_list) \
                if env is not None and env.world_size > 1 else _Local()
        return self._red

    # -- flat views over the parameter list (host float64) --
    def _flat_params(self):
        return np.concatenate(
            [p.detach().cpu().double().numpy().ravel()
             for p in self._parameter_list])

    def _flat_grads(self):
        return np.concatenate(
            [np.zeros(p.numel(), np.float64) if p.grad is None
             else p.grad.detach().cpu().double().numpy().ravel()
             for p in self._parameter_list])

    @torch.no_grad()
    def _assign(self, flat):
        i = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(torch.from_numpy(flat[i:i + n].reshape(p.shape)))
            i += n

    def _direction(self, g):
        dot = self._reductions().dot
        q = g.copy()
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / max(dot(y, s), 1e-20)
            a = rho * dot(s, q)
            alphas.append((a, rho, s, y))
            q -= a * y
        if self._y:
            y = self._y[-1]
            s = self._s[-1]
            q *= dot(s, y) / max(dot(y, y), 1e-20)
        for a, rho, s, y in reversed(alphas):
            b = rho * dot(y, q)
            q += (a - b) * s
        return -q

    # -- line searches ------------------------------------------------
    # Both return (loss, step_size, evals_used, accepted). On rejection
    # the caller restores the pre-step point: leaving parameters at a
    # failed (possibly worse-loss) trial point corrupts every following
    # iteration.

    def _armijo(self, eval_closure, flat, d, t, base, gd, eval_budget):
        evals = 0
        for _bt in range(20):
            if evals >= eval_budget:
                break
            self._assign(flat + t * d)
            trial = eval_closure()
            evals += 1
            if trial <= base + 1e-4 * t * gd:
                return trial, t, evals, True
            t *= 0.5
        return base, 0.0, evals, False

    def _strong_wolfe(self, eval_closure, flat, d, t, base, gd,
                      eval_budget, c1=1e-4, c2=0.9):
        """Bracket + bisection-zoom strong-Wolfe search (reference
        `python/paddle/optimizer/lbfgs.py` `_strong_wolfe`; bisection in
        place of its cubic interpolation — same conditions, a few more
        closure calls in the worst case)."""
        evals = 0

        def phi(step_size):
            nonlocal evals
            self._assign(flat + step_size * d)
            f = eval_closure()
            evals += 1
            return f, self._reductions().dot(self._flat_grads(), d)

        t_prev, f_prev, g_prev = 0.0, base, gd
        bracket = None
        f_new, g_new = base, gd
        for i in range(10):
            if evals >= eval_budget:
                # budget exhausted mid-bracketing: params sit at t_prev,
                # the best descending point found — keep that progress
                # (reference _strong_wolfe keeps the last iterate on
                # max_ls exhaustion) instead of discarding the iteration
                if f_prev < base and t_prev > 0.0:
                    return f_prev, t_prev, evals, True
                return base, 0.0, evals, False
            f_new, g_new = phi(t)
            if f_new > base + c1 * t * gd or (i > 0 and f_new >= f_prev):
                bracket = (t_prev, t, f_prev, f_new, g_prev, g_new)
                break
            if abs(g_new) <= -c2 * gd:
                return f_new, t, evals, True  # both conditions hold
            if g_new >= 0:
                bracket = (t, t_prev, f_new, f_prev, g_new, g_prev)
                break
            t_prev, f_prev, g_prev = t, f_new, g_new
            t *= 2.0
        if bracket is None:  # ran out of expansion steps while descending
            return f_new, t_prev, evals, f_new < base
        lo, hi, f_lo, f_hi, g_lo, g_hi = bracket
        for _ in range(10):
            if evals >= eval_budget or abs(hi - lo) * \
                    self._reductions().max_abs(d) <= self.tolerance_change:
                break
            mid = 0.5 * (lo + hi)
            f_mid, g_mid = phi(mid)
            if f_mid > base + c1 * mid * gd or f_mid >= f_lo:
                hi, f_hi, g_hi = mid, f_mid, g_mid
            else:
                if abs(g_mid) <= -c2 * gd:
                    return f_mid, mid, evals, True
                if g_mid * (hi - lo) >= 0:
                    hi, f_hi, g_hi = lo, f_lo, g_lo
                lo, f_lo, g_lo = mid, f_mid, g_mid
        if f_lo < base and evals < eval_budget:
            # Armijo point without curvature: still usable; the re-eval
            # leaves params+grads at the accepted point and must respect
            # the max_eval budget like every other closure call
            self._assign(flat + lo * d)
            f_lo = eval_closure()
            evals += 1
            return f_lo, lo, evals, True
        return base, 0.0, evals, False

    def step(self, closure=None):
        """One L-BFGS step: up to ``max_iter`` iterations and ``max_eval``
        closure calls; returns the last accepted loss (fp32, on the
        host)."""
        if closure is None:
            raise ValueError(
                "LBFGS.step needs a closure that reevaluates the model "
                "and returns the loss")

        red = self._reductions()

        def eval_closure():
            self.clear_grad()
            loss = closure()
            return red.same(float(loss.detach().double().cpu()))

        loss = eval_closure()
        evals = 1
        for _ in range(self.max_iter):
            flat = self._flat_params()
            g = self._flat_grads()
            if red.max_abs(g) <= self.tolerance_grad:
                break
            if self._prev_flat is not None:
                s = flat - self._prev_flat
                y = g - self._prev_grad
                if red.dot(y, s) > 1e-10:
                    self._s.append(s)
                    self._y.append(y)
                    if len(self._s) > self.history_size:
                        self._s.pop(0)
                        self._y.pop(0)
            self._prev_flat = flat
            self._prev_grad = g
            d = self._direction(g)
            gd = red.dot(g, d)
            if gd > -1e-20:  # not a descent direction: reset history
                d = -g
                gd = red.dot(g, d)
                self._s.clear()
                self._y.clear()
            t = float(self.get_lr())
            search = (self._strong_wolfe
                      if self.line_search_fn == "strong_wolfe"
                      else self._armijo)
            trial, t, used, ok = search(
                eval_closure, flat, d, t, loss, gd, self.max_eval - evals)
            evals += used
            if not ok:
                # restore the pre-step point; refresh its gradients if the
                # budget allows so a caller inspecting p.grad sees the
                # accepted point, not the failed trial
                self._assign(flat)
                if evals < self.max_eval:
                    eval_closure()
                    evals += 1
                break
            loss = trial
            if red.max_abs(t * d) <= self.tolerance_change:
                break
            if evals >= self.max_eval:
                break
        return torch.tensor(loss, dtype=torch.float32)
