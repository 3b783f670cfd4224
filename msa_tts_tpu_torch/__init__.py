"""msa_tts_tpu_torch — the PyTorch and CUDA port of ``msa_tts_tpu``.

The JAX package beside this one is the reference: every module here
mirrors a module path and function name there and is tested against it
on the same weights and the same noise (tests/test_torch_*.py).  The
port imports ``torch`` and never ``jax``.

The serving path (text → mel → wav) runs the autoregressive Tacotron-2
decoder as one hand-written CUDA kernel on the GPU
(``models/cuda_decoder.py``, ``csrc/decoder_loop.cu``) and as its plain
PyTorch version on the CPU.
"""

__version__ = "0.1.0"
