"""Parallel serving and training (counterpart of ``mqgan_tpu/parallel/``):
a list of devices in place of a JAX mesh (``mesh.py``, which also gives a
data-parallel rank its rows), sequence-parallel decode and re-encode of one
long clip (``seqpar.py``), process groups on ``torch.distributed``
(``multihost.py``), the data-parallel train step's reductions (``dp.py``)
and the LSTM stack's pipeline (``pipeline.py``). Data-parallel serving is
``deploy/runtime.py``'s ``devices``. Sequence-parallel training and tensor
parallelism are not ported (ROADMAP.md Queue 1 item 8c)."""
