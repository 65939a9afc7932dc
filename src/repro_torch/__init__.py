"""PyTorch/CUDA port of the SP-NGD system in ``repro``, for an NVIDIA H100.

Written in PyTorch, with hand-written Hopper kernels (``kernels/csrc``)
where the JAX package has Pallas kernels; it imports nothing of JAX or of
``repro``. Entry points run on the card unless the caller passes
``device="cpu"``; on the CPU every op takes its plain PyTorch version.

Ported so far, for ``llama3_2_1b``: the serving path
(``serve.ContinuousBatcher`` -> ``DecoderLM.prefill/decode_step``); the
SP-NGD trainer (``launch.train``: capture, Algorithm-2 staleness, Stage 4
by eigh, Cholesky or Newton-Schulz, preconditioning and the momentum
update, f32 or fp8 factor history, fused fp8 capture, the double buffer,
the chunked refresh pipeline) and the momentum-SGD baseline
(``optim.SGD``); checkpoints in ``repro``'s layout (``checkpoint``);
multi-GPU Stage 3 and Stage 4 over ``torch.distributed`` (``comm``); and
observability (``obs``: stage and kernel ranges, the JSONL metrics
stream). For ``resnet50``, the paper's own model: the ConvNet with conv
K-FAC and the unit-wise or full BatchNorm Fisher, trained by the paper's
scheme (``launch.train_convnet``). All thirteen Pallas kernels have a CUDA
counterpart (``kernels/csrc``).
"""
