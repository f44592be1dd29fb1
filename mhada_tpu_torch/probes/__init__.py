"""H100 probes: the counterparts of the JAX package's TPU probe scripts.

- ``mm_probe`` (P1, scripts/mxu_probe.py): a bf16 tensor-core matmul at
  the attention tile shapes, with ``torch.matmul`` (cuBLAS) beside it;
- ``mhada_pipe_probe`` (P2, scripts/mhada_pipe_probe.py): K3's function
  with its key tiles loaded by ``cp.async`` into a double buffer, timed
  against K3;
- ``ln_matmul_split``: K2's bf16 kernel timed beside scratch builds with
  its product, its LN prologue or its W loads cut out (no TPU
  counterpart; card only).

Each is a module with a CLI (``python -m mhada_tpu_torch.probes.<name>``)
that runs on the card unless ``--device cpu`` is given.
"""
