"""The sharded frame step on ``torch.distributed`` (counterpart of
``semantic_dsp_map_tpu/parallel/``): ``shard_step.build_shard_step``,
``sharding.shard_state`` and ``distributed.initialize`` /
``spawn_ranks`` / ``weak_scaling_report``."""
