"""Multi-process training and evaluation over ``torch.distributed`` — port of ``parallel/``.

- :mod:`.mesh` — process-group set-up from the launcher's environment and
  the ``('data', 'model')`` device mesh;
- :mod:`.sharding` — where the parameters live on that mesh: data parallel
  (DDP), ZeRO-3 (FSDP2) or Megatron tensor parallel, and the whole-state
  gather and re-placement that checkpoints use;
- :mod:`.collectives` — the differentiable collectives the layers call
  under tensor parallelism and the global BatchNorm statistics.

Nothing here is imported by the package root: the models import
:mod:`.collectives` only.
"""
