"""Parallel codec serving on one controller (counterpart of the serving part
of ``mqgan_tpu/parallel/``): a list of devices in place of a JAX mesh
(``mesh.py``), sequence-parallel decode and re-encode of one long clip
(``seqpar.py``). Data-parallel serving is ``deploy/runtime.py``'s
``devices``. Parallel training on ``torch.distributed`` is not ported
(ROADMAP.md Queue 1 item 8b)."""
