"""The port of ``ascendpathtracing_tpu/parallel``: so far the single-device
training step of ``sharded`` (``split_scene_params``,
``make_train_step(None, ...)``)."""
