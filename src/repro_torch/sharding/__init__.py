from .specs import (STRATEGIES, MeshShape, PartitionSpec, batch_specs,
                    cache_specs, leaf_spec, param_specs, port_param_specs,
                    sharded_bytes, tree_placements)

__all__ = ["STRATEGIES", "MeshShape", "PartitionSpec", "batch_specs",
           "cache_specs", "leaf_spec", "param_specs", "port_param_specs",
           "sharded_bytes", "tree_placements"]
