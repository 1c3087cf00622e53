"""Multi-device training (counterpart of caster_dta_tpu/parallel/): process
groups and data parallelism (mesh.py), and edge-partitioned protein graphs
with their halo exchange (partition.py)."""
