"""The traffic generators, one module per traffic file's 'kind': each
has make(traffic, cfg, seed, device) (see portbench/harness/traffic.py)."""
