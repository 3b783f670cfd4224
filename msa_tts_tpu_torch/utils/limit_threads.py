"""Host BLAS/OMP thread cap (the port's own copy of
``msa_tts_tpu/utils/limit_threads.py``; reference:
msa_tts/utils/limit_threads.py — imported first by every entry script to
pin OMP/MKL/BLAS to 4 threads).

The GPU does the model's math, but the host still runs numpy DSP for the
feature cache; importing this module (before numpy or torch) caps the
host's threads so data preprocessing does not oversubscribe the machine.
Override with ``MSA_NUM_THREADS``.
"""

import os

N_THREADS = os.environ.get("MSA_NUM_THREADS", "4")

for var in (
    "OMP_NUM_THREADS",
    "OPENBLAS_NUM_THREADS",
    "MKL_NUM_THREADS",
    "VECLIB_MAXIMUM_THREADS",
    "NUMEXPR_NUM_THREADS",
):
    os.environ.setdefault(var, N_THREADS)
