"""PyTorch/CUDA port of the SP-NGD system in ``repro``, for an NVIDIA H100.

Written in PyTorch, with hand-written Hopper kernels (``kernels/csrc``)
where the JAX package has Pallas kernels; it imports nothing of JAX or of
``repro``. Entry points run on the card unless the caller passes
``device="cpu"``; on the CPU every op takes its plain PyTorch version.

Ported so far: the serving path (``serve.ContinuousBatcher`` ->
``models.transformer.DecoderLM.prefill/decode_step``) for dense decoders,
with the prefill attention forward and the flash-decode kernels.
"""
