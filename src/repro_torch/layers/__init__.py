"""Model layers: norms/rope/mlp (common), GQA attention, planned
embeddings. MoE, Mamba2 SSD and RWKV6 are ROADMAP.md queue 1, item 3."""
