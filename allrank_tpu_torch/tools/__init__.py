"""The port's probe CLIs, the counterparts of the JAX package's
``tools/exp_*.py`` probes that carry a kernel of their own:

- ``exp_boundary_shift``: what a kernel boundary costs, and whether a
  boundary that ends in a product costs less than a bare residual (X2);
- ``exp_attn_decompose``: B1's forward time split by stage (X3);
- ``exp_sinkhorn_layout``: B8 with its Sinkhorn records on chip (X4).

Each runs as ``python -m allrank_tpu_torch.tools.<probe>`` on the card, or
with ``--device cpu`` on the plain versions (for the tests; its times are
then the CPU's, not the card's). ``timing`` holds their clocks.
"""
