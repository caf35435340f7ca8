"""Batched serving engine: continuous-batching decode over the model's
cache, with RelShard stage-boundary re-planning on measured occupancy.

The engine keeps one fixed-shape decode step (batch = ``max_batch``) and
fills slots from a FIFO request queue (continuous batching). Measured
occupancy is the adaptive runtime statistic: ``maybe_replan`` re-runs the
planner with it (paper §4.1 re-optimization) and reports when the physical
plan would change.

A request's tokens depend on its prompt alone, never on what else shares
the batch: admission zeros the slot's rows of every cache leaf (K/V, the
recurrent states and conv tails, the hybrid's attention rows), so a new
request starts from the zero state ``forward`` assumes, resets the slot's
position to 0, and teacher-forces the prompt through ``decode_step`` on
that slot's rows of the cache only, so no other slot's state or position
moves. (The reference engine advances and writes every slot while it
admits one, and never resets a reused slot; see ``ROADMAP.md`` §3.) A
request that would write past ``max_seq`` is refused at ``submit``.

For the MoE families the guarantee holds while no assignment is dropped:
the experts' slots are shared by the batch. A token picks an expert at
most once, so a decode step gives an expert at most ``max_batch``
assignments, against a capacity of ``moe.moe_capacity(max_batch *
top_k, n_experts)``, at least 8: with ``max_batch`` <= 8 (or any batch
within that capacity) nothing is dropped. ``dropped_decode_calls`` counts
the decode calls in which some layer dropped an assignment.

The engine keeps one copy of the weights on its device
(``lm.cast_params``): bf16 but for the few leaves the reference reads in
f32. Every use casts any other weight to bf16 first, so the copy gives the
same bits as casting at every step, and a decode step reads half the bytes.

On a mesh every rank runs the same engine (SPMD): the same queue, the same
admissions, its blocks of the weights (``lm.param_specs``) and of the
cache (``lm.init_cache(..., mesh=)``). A slot's admission runs on the
ranks that hold its cache rows (all of them when the batch does not split
over the batch axes), and on a spare row on the others, which join its
collectives. Each step gathers the logits whole, takes the argmax, then
all-gathers every rank's tokens and requires them equal.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import torch

from ..core.relshard import ShardingPlan, replan
from ..joins.table import resolve_device
from ..models import lm
from ..models import sharding as sh
from ..models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, plan: ShardingPlan, mesh, params,
                 max_batch: int = 8, max_seq: int = 512,
                 mesh_axes=None, shape: Optional[ShapeConfig] = None,
                 device=None):
        self.cfg, self.plan, self.mesh = cfg, plan, mesh
        self.max_batch, self.max_seq = max_batch, max_seq
        self.mesh_axes, self.shape = mesh_axes, shape
        self.device = resolve_device(device)
        self.weights = lm.cast_params(params, self.device)
        self.cache = lm.init_cache(cfg, max_batch, max_seq, self.device,
                                   mesh=mesh, plan=plan)
        self.ctx = lm.shard_ctx(plan, mesh, max_batch, max_seq=max_seq,
                                cfg=cfg)
        self.slots: List[Optional[Request]] = [None] * max_batch
        # FIFO admission queue; popleft is O(1) under deep backlogs.
        self.queue: Deque[Request] = collections.deque()
        self._next: Dict[int, int] = {}       # slot -> token it feeds next
        # decode calls that dropped an MoE assignment (a device counter)
        self._dropped = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        self.replan_events: List[str] = []

    # -- queueing -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt")
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid}: a prompt of {len(req.prompt)} tokens "
                f"and {req.max_new_tokens} new tokens exceed max_seq = "
                f"{self.max_seq}")
        self.queue.append(req)

    def _decode(self, tokens, cache, ctx=None):
        ctx = ctx or self.ctx
        if not self.cfg.is_moe:
            return lm.decode_step(self.weights, self.cfg, self.plan,
                                  self.mesh, tokens, cache, ctx=ctx)
        aux: List = []
        out = lm.decode_step(self.weights, self.cfg, self.plan, self.mesh,
                             tokens, cache, moe_aux=aux, ctx=ctx)
        self._dropped += (torch.stack([a.dropped for a in aux]) > 0).any()
        return out

    @property
    def dropped_decode_calls(self) -> int:
        """Decode calls (batched steps and admission's per-slot steps) in
        which some MoE layer dropped an assignment; 0 for other families."""
        return int(self._dropped)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.popleft()
                self.slots[i] = req
                self._prefill_slot(i, req.prompt[:-1])
                self._next[i] = req.prompt[-1]

    def _prefill_slot(self, i: int, tokens: List[int]) -> None:
        """Zero slot ``i``'s state, reset its position and teacher-force
        ``tokens`` through decode steps on its rows of the cache alone
        (views, written in place). Every cache leaf but ``pos`` has the
        batch on axis 1 (on a mesh, this rank's rows of it; ``pos`` is
        whole on every rank). On a mesh whose batch axes split the slots,
        a rank that does not hold slot ``i`` runs the same steps on a
        spare row, so that every rank joins the collectives of the steps
        (the weights' gathers over the fsdp axes among them)."""
        row, ctx, leaves = i, self.ctx, self.cache
        if ctx is not None and ctx.batch:
            rows = self.max_batch // self.mesh.n(ctx.batch)
            row -= self.mesh.index(ctx.batch) * rows
            ctx = dataclasses.replace(ctx, batch=())
            if not 0 <= row < rows:     # another rank holds the slot
                row, leaves = 0, {name: torch.empty_like(leaf[:, :1])
                                  for name, leaf in leaves.items()
                                  if name != "pos"}
        for name, leaf in leaves.items():
            if name != "pos":
                leaf[:, row].zero_()
        self.cache["pos"][i] = 0
        view = {name: self.cache["pos"][i:i + 1] if name == "pos"
                else leaves[name][:, row:row + 1] for name in self.cache}
        feed = torch.tensor(tokens, dtype=torch.int32, device=self.device)
        for t in range(len(tokens)):
            _, view = self._decode(feed[t:t + 1, None], view, ctx)
        self.cache["pos"][i] = len(tokens)

    # -- decode ----------------------------------------------------------------

    def occupancy(self) -> int:
        return sum(s is not None for s in self.slots)

    def step(self) -> Dict[int, int]:
        """One batched decode step for all live slots. Returns {rid: token}."""
        self._admit()
        feed = [self._next[i] if req is not None else 0
                for i, req in enumerate(self.slots)]
        tokens = torch.tensor(feed, dtype=torch.int32,
                              device=self.device)[:, None]
        logits, self.cache = self._decode(tokens, self.cache)
        if self.mesh is not None:
            out = self._agreed_tokens(logits)
        else:
            out = torch.argmax(logits, dim=-1).tolist()
        emitted: Dict[int, int] = {}
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(out[i])
            req.out.append(tok)
            self._next[i] = tok
            emitted[req.rid] = tok
            if len(req.out) >= req.max_new_tokens:
                req.done = True
                self.slots[i] = None
        return emitted

    def _agreed_tokens(self, logits) -> List[int]:
        """The step's tokens from this rank's block of the logits: the
        logits gathered whole, their argmax, and every rank's tokens
        gathered and required equal."""
        vocab = (self.plan.model_axis
                 if self.plan.head_strategy == "vocab_parallel" else None)
        whole = sh.unshard(logits, sh.P(self.ctx.batch or None, vocab),
                           self.mesh)
        toks = torch.argmax(whole, dim=-1)
        every = sh.all_gather_raw(self.mesh, toks[None],
                                  self.mesh.axis_names, 0)
        if not bool((every == toks[None]).all()):
            raise RuntimeError("ranks disagree on the step's tokens: "
                               f"{every.tolist()}")
        return toks.tolist()

    # -- adaptive re-planning ----------------------------------------------------

    def maybe_replan(self) -> Optional[ShardingPlan]:
        """Paper §4.1 step 2-3 at a serving stage boundary: feed measured
        occupancy (runtime statistic) back into the cost model. Returns the
        new plan if any strategy changed, else None."""
        if self.mesh_axes is None or self.shape is None:
            return None
        new = replan(self.plan, self.cfg, self.mesh_axes, self.shape,
                     measured_tokens=max(self.occupancy(), 1))
        changed = (new.embed_strategy != self.plan.embed_strategy
                   or new.head_strategy != self.plan.head_strategy
                   or new.moe_strategy != self.plan.moe_strategy)
        if changed:
            self.replan_events.append(
                f"occupancy={self.occupancy()}: "
                f"embed {self.plan.embed_strategy}->{new.embed_strategy}, "
                f"moe {self.plan.moe_strategy}->{new.moe_strategy}")
            return new
        return None
