"""More than one process (counterpart of unidepth_tpu/parallel): the mesh of
process groups, the sharding rules, the collectives of data, FSDP and tensor
parallelism (``mesh``), and the tensor-parallel model surgery (``tp``)."""
