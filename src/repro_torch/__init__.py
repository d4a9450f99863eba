"""PyTorch/CUDA port of the densest-subgraph system (P-Bahmani, CBDS-P).

Mirrors the layout and names of the JAX package ``repro`` and is held
against it, but imports neither JAX nor that package. Entry points run on
the GPU unless given ``device="cpu"``.
"""
