"""PyTorch and CUDA port of the Morpheus reproduction.

The JAX package ``repro`` is the reference; this package grows beside it
one slice at a time and imports nothing from it.  It runs:

- the simulation campaign (``repro_torch.core.campaign.run_scenario``)
  with the per-row segment-sum kernel (``kernels.segment_sum``);
- the serving engine of the decoder-only models
  (``repro_torch.serving.engine.ServingEngine``, qwen2-vl-7b), whose
  prefill runs the flash-attention kernel (``kernels.flash_attention``)
  and whose decode steps run the flash-decoding kernel
  (``kernels.decode_attention``).

Entry points take ``device=None``, which means the CUDA card; without one
they raise unless the caller passes ``device="cpu"``.
"""
