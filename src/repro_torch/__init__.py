"""PyTorch and CUDA port of the Morpheus reproduction.

The JAX package ``repro`` is the reference; this package grows beside it
one slice at a time and imports nothing from it.  The first slice is the
simulation campaign (``repro_torch.core.campaign.run_scenario``) with its
one hand-written kernel, the per-row segment sum
(``repro_torch.kernels.segment_sum``).

Entry points take ``device=None``, which means the CUDA card; without one
they raise unless the caller passes ``device="cpu"``.
"""
