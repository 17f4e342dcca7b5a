"""The parallel strategies of byteps_tpu/parallel/. Their shard_map tier:
a named mesh of processes (``mesh``), the ``jax.lax`` collectives over
its axes with JAX's transposes (``collectives``), the job's process
group (``distributed``), the sharding tables and each rank's slice of
the parameters (``sharding``), ring attention and Ulysses over ``sp``
(``ring_attention``, ``ulysses``), and the pipeline over ``pp``
(``pipeline``); MoE's expert parallelism over ``ep`` lives in
``models/moe.py``. Their GSPMD tier, whose collectives XLA writes in
JAX and the port writes itself: Megatron tensor parallelism over ``tp``
(``tensor_parallel``, with the region pairs of ``collectives``), FSDP
over ``dp`` (``fsdp``), and the step over a mesh (``spmd``)."""
