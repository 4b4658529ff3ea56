"""Jobs that run on the port: scripts a tony-tpu job executes."""
