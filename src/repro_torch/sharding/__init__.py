from .specs import (STRATEGIES, MeshShape, PartitionSpec, batch_specs,
                    cache_specs, leaf_spec, make_abstract_mesh, param_specs,
                    port_param_specs, sharded_bytes, step_placements,
                    tree_placements)

__all__ = ["STRATEGIES", "MeshShape", "PartitionSpec", "batch_specs",
           "cache_specs", "leaf_spec", "make_abstract_mesh", "param_specs",
           "port_param_specs", "sharded_bytes", "step_placements",
           "tree_placements"]
