"""Optimizers: AdamW (default) and Adafactor (factored second moment, for
the 100B+ MoE configs where full Adam state would not fit on one card).

States are trees of tensors with the JAX package's structure, so that a
checkpoint carries across between the two packages. Gradient
"compression": grads can be cast to bf16 before the update.

Every operation is the reference's, in fp32 and in its order, so that an
update equals the reference's to fp32 rounding; the step, the warm-up
ratio and the bias corrections are fp32 tensor arithmetic on the int32
step, as in the reference. ``apply_updates`` writes the params and the
state in place (the reference donates both buffers to XLA), and walks each
leaf in pieces of at most ``PIECE_ELEMS`` elements: AdamW is elementwise,
and every operation of Adafactor stays within a leaf's trailing two axes,
so the pieces give the same values as the whole leaf while their
temporaries stay small.

On a mesh (``mesh=`` and the params' ``specs``) every rank updates its
blocks. The global gradient norm adds each leaf's local sum of squares
over exactly the axes the leaf is split on, so a replicated leaf counts
once; Adafactor's row and column means over a split dimension add over
that dimension's axes and divide by its whole length. The state mirrors
the params' specs (``opt_state_specs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import torch

from ..models import lm
from ..models import sharding as sh
from .tree import tree_leaves, tree_map

#: The largest piece of a leaf that one update touches at a time.
PIECE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # "adamw" | "adafactor"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    grad_dtype: str = "float32"    # "bfloat16" -> compressed reduction


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), fp32. The warm-up
    ratio multiplies by the fp32 reciprocal of the warm-up steps, as XLA
    computes the reference's division by that constant."""
    warm = torch.clamp(step.float() * (1 / max(cfg.warmup_steps, 1)),
                       max=1.0)
    return cfg.lr * warm


def init_opt_state(cfg: OptConfig, params) -> Dict[str, Any]:
    device = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.name == "adamw":
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params),
                "step": step}
    if cfg.name == "adafactor":
        def row_col(p):
            if p.dim() < 2:
                return {"v": torch.zeros_like(p)}
            return {"vr": p.new_zeros(p.shape[:-1]),
                    "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:])}
        return {"fact": tree_map(row_col, params), "step": step}
    raise ValueError(f"unknown optimizer {cfg.name}")


def opt_state_specs(cfg: OptConfig, param_specs_tree):
    """Specs of the optimizer state: they mirror the params'."""
    if cfg.name == "adamw":
        return {"mu": param_specs_tree, "nu": param_specs_tree,
                "step": sh.P()}

    def row_col_spec(spec):
        parts = tuple(spec)
        if len(parts) < 2:
            return {"v": spec}
        return {"vr": sh.P(*parts[:-1]), "vc": sh.P(*parts[:-2], parts[-1])}
    return {"fact": lm._map_tree(row_col_spec, param_specs_tree),
            "step": sh.P()}


def opt_state_from_numpy(tree, device) -> Dict[str, Any]:
    """An optimizer state of numpy arrays (e.g. the reference's through
    ``np.asarray``) as tensors on ``device``."""
    return lm.params_from_numpy(tree, device)


def opt_state_to_numpy(state) -> Dict[str, Any]:
    return lm.params_to_numpy(state)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as (rows, last axis), a view: elementwise pieces are runs of
    rows, and writes to them land in ``t``."""
    return t.view(1, -1) if t.dim() < 2 else t.view(-1, t.shape[-1])


def _row_pieces(n_rows: int, row_elems: int) -> Iterator[slice]:
    step = max(1, PIECE_ELEMS // max(row_elems, 1))
    for i in range(0, n_rows, step):
        yield slice(i, i + step)


def _grad_piece(cfg: OptConfig, g: torch.Tensor) -> torch.Tensor:
    if cfg.grad_dtype == "bfloat16":
        g = g.to(torch.bfloat16)
    return g.float()


def _split_axes(mesh, spec) -> tuple:
    """The mesh axes a leaf under ``spec`` is split on, in mesh order."""
    if mesh is None:
        return ()
    held = {a for e in spec for a in sh.spec_axes(e)}
    return tuple(a for a in mesh.axis_names if a in held)


def _global_norm(cfg: OptConfig, grads, mesh=None, specs=None
                 ) -> torch.Tensor:
    """sqrt of the sum, in leaf order, of each leaf's sum of squares. On a
    mesh each leaf's local sum is added over the axes it is split on (the
    leaves of one set of axes share one all-reduce)."""
    spec_leaves = (tree_leaves(specs) if mesh is not None
                   else [None] * len(tree_leaves(grads)))
    totals: Dict[tuple, torch.Tensor] = {}
    for g, spec in zip(tree_leaves(grads), spec_leaves):
        rows = _rows(g.contiguous())
        sq = None
        for sl in _row_pieces(rows.shape[0], rows.shape[1]):
            part = torch.sum(torch.square(_grad_piece(cfg, rows[sl])))
            sq = part if sq is None else sq + part
        key = _split_axes(mesh, spec)
        totals[key] = totals[key] + sq if key in totals else sq
    total = 0
    for key in sorted(totals):
        part = totals[key]
        if key:
            part = sh.all_reduce_raw(mesh, part, key)
        total = total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, opt_state, grads, *, mesh=None,
                  specs=None) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """One optimizer step. Returns (params, opt_state, metrics); params and
    state are the tensors passed in, updated in place. On a mesh, params,
    state and grads are the rank's blocks under ``specs`` (the params')."""
    gnorm = _global_norm(cfg, grads, mesh, specs)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt_state["step"]
    step.add_(1)
    lr = lr_at(cfg, step)
    stepf = step.float()
    leaves_p, leaves_g = tree_leaves(params), tree_leaves(grads)

    if cfg.name == "adamw":
        bc1 = 1 - torch.pow(cfg.b1, stepf)
        bc2 = 1 - torch.pow(cfg.b2, stepf)
        for p, g, m, v in zip(leaves_p, leaves_g,
                              tree_leaves(opt_state["mu"]),
                              tree_leaves(opt_state["nu"])):
            p, g, m, v = _rows(p), _rows(g.contiguous()), _rows(m), _rows(v)
            for sl in _row_pieces(p.shape[0], p.shape[1]):
                _adamw_piece(cfg, p[sl], _grad_piece(cfg, g[sl]) * scale,
                             m[sl], v[sl], lr, bc1, bc2)
        return params, opt_state, {"grad_norm": gnorm, "lr": lr}

    if cfg.name != "adafactor":
        raise ValueError(f"unknown optimizer {cfg.name}")
    # adafactor (beta1=0 variant)
    d2 = 1 - torch.pow(0.999, stepf)
    spec_leaves = (tree_leaves(specs) if mesh is not None
                   else [None] * len(leaves_p))
    for p, g, f, spec in zip(leaves_p, leaves_g,
                             _iter_fact(opt_state["fact"], params),
                             spec_leaves):
        if p.dim() < 2:
            _adafactor_vector(cfg, p, _grad_piece(cfg, g) * scale, f["v"],
                              lr, d2)
            continue
        a, b = p.shape[-2:]
        # the axes the last two dimensions are split on
        ax = ((), ()) if mesh is None else (sh.spec_axes(tuple(spec)[-2]),
                                            sh.spec_axes(tuple(spec)[-1]))
        p3, g3 = p.view(-1, a, b), g.contiguous().view(-1, a, b)
        vr, vc = f["vr"].view(-1, a), f["vc"].view(-1, b)
        for sl in _row_pieces(p3.shape[0], a * b):
            _adafactor_matrices(cfg, p3[sl],
                                _grad_piece(cfg, g3[sl]) * scale,
                                vr[sl], vc[sl], lr, d2, mesh, ax)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def _adamw_piece(cfg, p, g, m, v, lr, bc1, bc2) -> None:
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
    upd = m / bc1
    den = (v / bc2).sqrt_().add_(cfg.eps)
    upd.div_(den)
    upd.add_(torch.mul(p, cfg.weight_decay, out=den)).mul_(lr)
    p.sub_(upd)


def _apply(cfg, p, g, den, tmp, lr) -> None:
    """p -= lr * (g / den + weight_decay * p), ``den`` holding the
    denominator (overwritten) and ``tmp`` a scratch of p's shape."""
    torch.div(g, den, out=den)
    den.add_(torch.mul(p, cfg.weight_decay, out=tmp)).mul_(lr)
    p.sub_(den)


def _adafactor_vector(cfg, p, g, v, lr, d2) -> None:
    g2 = (g * g).add_(1e-30)
    v.mul_(0.999).add_(g2.mul_(0.001))
    den = (v / d2).sqrt_().add_(cfg.eps)
    _apply(cfg, p, g, den, g2, lr)


def _adafactor_matrices(cfg, p, g, vr, vc, lr, d2, mesh=None,
                        axes=((), ())) -> None:
    """Pieces of (n, a, b) matrices with their (n, a) and (n, b) factors.
    ``axes``: the mesh axes dimensions a and b are split on (their sums
    add over them; the means divide by the whole lengths)."""
    a, b = p.shape[-2:]
    ax_a, ax_b = axes
    if mesh is not None:
        a, b = a * mesh.n(ax_a), b * mesh.n(ax_b)

    def total(t, ax):
        return sh.all_reduce_raw(mesh, t, ax) if ax else t
    g2 = (g * g).add_(1e-30)
    vr.mul_(0.999).add_(total(g2.sum(dim=-1), ax_b).div_(b).mul_(0.001))
    vc.mul_(0.999).add_(total(g2.sum(dim=-2), ax_a).div_(a).mul_(0.001))
    rfac = (vr / total(vr.sum(dim=-1, keepdim=True), ax_a).div_(a))[
        ..., None]
    vhat = rfac * vc[..., None, :]
    vhat.div_(d2).sqrt_().add_(cfg.eps)
    _apply(cfg, p, g, vhat, g2, lr)


def _iter_fact(fact, params):
    """The factored-state dict of every param leaf, in leaf order."""
    def walk(f, p):
        if isinstance(p, dict):
            for k in sorted(p):
                yield from walk(f[k], p[k])
        else:
            yield f
    return walk(fact, params)
