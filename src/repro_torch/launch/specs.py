"""Stand-ins for every entry-point input (meta tensors: the right shape
and dtype, no memory) paired with their ``P``, and the spec trees of each
(arch x shape x mesh) cell: the reference's ``launch/specs.py``.

``mesh`` is anything with ``shape`` ({axis: size}): a ``models.sharding.
Mesh`` or an ``AbstractMesh``, so specs need no process group.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..core.relshard import ShardingPlan
from ..models import lm
from ..models.config import ModelConfig, ShapeConfig
from ..models.sharding import P
from ..training.optimizer import OptConfig, init_opt_state, opt_state_specs


def _batch_shards(plan: ShardingPlan, mesh) -> int:
    return math.prod(mesh.shape[a] for a in plan.batch_axes)


def batch_pspec(plan: ShardingPlan, mesh, global_batch: int) -> P:
    """Batch dim sharding; replicated when the batch doesn't divide (e.g.
    long_500k's single sequence: model-parallel only, data axes idle)."""
    if global_batch % _batch_shards(plan, mesh) == 0:
        return P(plan.batch_axes)
    return P()


def input_specs(cfg: ModelConfig, shape: ShapeConfig, plan: ShardingPlan,
                mesh) -> Dict[str, Any]:
    """(meta tensor, P) for each of the cell's model inputs."""
    B = shape.global_batch
    bp = batch_pspec(plan, mesh, B)

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        out = {"tokens": (meta((B, 1), torch.int32), bp)}
        cache = lm.init_cache(cfg, B, shape.seq_len, device="meta")
        out["cache"] = {k: (v, _cache_pspec(tuple(v.shape), cfg, plan, mesh,
                                            B))
                        for k, v in cache.items()}
        return out

    S_text = shape.seq_len - cfg.n_cond_tokens
    out = {"tokens": (meta((B, S_text), torch.int32), bp)}
    if cfg.n_cond_tokens:
        out["cond_emb"] = (meta((B, cfg.n_cond_tokens, cfg.d_model),
                                torch.bfloat16), bp)
    return out


#: the reference's name for the cache placement, which lives beside the
#: cache (``lm.cache_pspec``)
_cache_pspec = lm.cache_pspec


def model_shardings(cfg: ModelConfig, plan: ShardingPlan, mesh,
                    opt_cfg: OptConfig | None = None):
    """(params as (meta tensor, P) pairs, the optimizer state's ditto or
    None, the param spec tree)."""
    params_shape = lm.init_params(cfg, 0, device="meta")
    specs = lm.param_specs(cfg, params_shape, plan)
    p_sds = lm.sh.map_specs(lambda t, s: (t, s), params_shape, specs)
    if opt_cfg is None:
        return p_sds, None, specs
    opt_shape = init_opt_state(opt_cfg, params_shape)
    o_specs = opt_state_specs(opt_cfg, specs)
    o_sds = lm.sh.map_specs(lambda t, s: (t, s), opt_shape, o_specs)
    return p_sds, o_sds, specs
