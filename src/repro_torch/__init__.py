"""PyTorch and CUDA port of the Morpheus reproduction.

The JAX package ``repro`` is the reference; this package grows beside it
one slice at a time and imports nothing from it.  It runs:

- the simulation campaign (``repro_torch.core.campaign.run_scenario``)
  with the per-row segment-sum kernel (``kernels.segment_sum``);
- the serving engine of the decoder-only models
  (``repro_torch.serving.engine.ServingEngine``, qwen2-vl-7b), whose
  prefill runs the flash-attention kernel (``kernels.flash_attention``)
  and whose decode steps run the flash-decoding kernel
  (``kernels.decode_attention``);
- the Morpheus router across serving replicas
  (``repro_torch.serving.router.MorpheusRouter``) over the policy engine
  (``repro_torch.core.balancer``) and the prediction plane.
- the dry-run of every production cell as one rank of the production
  mesh (``python -m repro_torch.launch.dryrun``: the reference's
  ``launch/specs.py`` cells, ``launch/hlo.py``'s counts as
  ``launch/counts.py``, ``launch/dryrun_lib.py``).

Entry points take ``device=None``, which means the CUDA card; without one
they raise unless the caller passes ``device="cpu"``.
"""
