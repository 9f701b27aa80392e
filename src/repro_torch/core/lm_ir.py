"""Layer IR extraction for LM architectures — feeds the Fig. 1 DSE.

Summarises an (ArchConfig × ShapeSpec) cell into per-layer-class
:class:`LayerSpec`s (attention projections, MLP, experts, embeddings) so
``run_dse`` can make the folding and sparsity decisions per layer.  A copy
of ``repro.core.lm_ir``.
"""
from __future__ import annotations

from typing import List

from .cost_model import LayerSpec

__all__ = ["lm_layer_specs"]


def lm_layer_specs(cfg, shape) -> List[LayerSpec]:
    """One LayerSpec per layer class per layer (flattened), per step.

    decode: one token per sequence (B tokens); train/prefill: B×T tokens.
    Attention, MLP, experts and the SSM projections are prunable (block
    density ≤ 0.5, element density ≤ 0.25); the embeddings stay dense.  An
    MoE layer holds every expert's weights but moves only the active ones
    (top-k + shared) per token.  A hybrid layer ``i`` with ``i %
    attn_every == 0`` is the shared attention + MLP, the others Mamba2.
    """
    B = shape.global_batch
    tokens = B * (shape.seq_len if shape.kind != "decode" else 1)
    D, Dh, H, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    act = 2.0 * tokens * D  # bf16 in+out per layer (approx)
    specs: List[LayerSpec] = []

    def add(name, wel, prunable=True, bd=0.5, ed=0.25, extra_flops=0.0):
        specs.append(LayerSpec(
            name=name, kind="linear",
            flops=2.0 * tokens * wel + extra_flops,
            weight_elems=int(wel), act_bytes=act,
            prunable=prunable,
            max_block_density=bd if prunable else 1.0,
            max_element_density=ed if prunable else 1.0,
        ))

    attn_w = D * (H * Dh) + 2 * D * (Hkv * Dh) + (H * Dh) * D
    attn_flops = 4.0 * tokens * shape.seq_len * H * Dh  # qk + pv
    for i in range(cfg.n_layers):
        fam = cfg.family
        if fam in ("dense", "encoder", "vlm") or (
                fam == "hybrid" and cfg.attn_every and i % cfg.attn_every == 0):
            add(f"attn_{i}", attn_w, extra_flops=attn_flops)
            if cfg.d_ff:
                add(f"mlp_{i}",
                    (3 if cfg.act == "swiglu" else 2) * D * cfg.d_ff)
        elif fam == "moe":
            add(f"attn_{i}", attn_w, extra_flops=attn_flops)
            e_w = 3 * D * cfg.d_expert
            active = cfg.top_k + cfg.n_shared_experts
            add(f"moe_{i}", e_w * (cfg.n_experts + cfg.n_shared_experts),
                bd=0.5, ed=0.25)
            specs[-1].flops = 2.0 * tokens * e_w * active
        elif fam == "ssm":
            add(f"mlstm_{i}", 4 * D * cfg.d_inner + cfg.d_inner * D)
        elif fam == "hybrid":
            add(f"mamba_{i}", 3 * D * cfg.d_inner + cfg.d_inner * D)
    add("embed_unembed", cfg.vocab * D * (1 if cfg.tie_embeddings else 2),
        prunable=False)
    return specs
