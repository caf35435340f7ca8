"""Model layers: norms/rope/mlp (common), GQA attention, planned
embeddings, MoE with slotted dispatch, Mamba2 SSD and RWKV6."""
