"""PyTorch + CUDA port of ``dismember_tpu``: the TDM and JTM workflows
with the DIN scorer (training, beam-search serving, tree clustering, JTM
tree learning, the alternation drivers and the ``tdm-*``/``jtm-*`` CLI).

Module paths mirror the JAX package.  The port imports torch and numpy only
(never jax, never ``dismember_tpu``) and keeps its own copy of every host
module it needs.  Entry points run on the GPU (``device="cuda"``) unless the
caller passes ``device="cpu"``; the DIN scorer's two kernels
(``ops/din_kernel.py``, ``ops/packed_level_kernel.py``) are hand-written
CUDA for Hopper (``csrc/din_kernels.cu``).
"""
