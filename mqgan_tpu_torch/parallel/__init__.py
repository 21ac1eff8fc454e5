"""Parallel serving and training (counterpart of ``mqgan_tpu/parallel/``):
a list of devices in place of a JAX mesh and the data x seq grid of the
training ranks (``mesh.py``), sequence-parallel decode and re-encode of
one long clip (``seqpar.py``), process groups on ``torch.distributed``
(``multihost.py``), the data-parallel train step's reductions (``dp.py``),
sequence-parallel training's halo exchanges and reductions over a seq
group (``seqtrain.py``) and the LSTM stack's pipeline (``pipeline.py``).
Data-parallel serving is ``deploy/runtime.py``'s ``devices``. Tensor
parallelism is not ported (no JAX entry point builds it: ROADMAP.md Queue
1 item 8d)."""
