"""The mesh: one process per card over ``torch.distributed``, ray-sharded
training steps and chunk-sharded frame renders."""
