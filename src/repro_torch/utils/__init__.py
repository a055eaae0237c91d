from repro_torch.utils.tree import (count_params, param_bytes, to_numpy,
                                    tree_leaves, tree_map,
                                    tree_map_with_path_names, tree_paths,
                                    tree_unflatten)

__all__ = ["count_params", "param_bytes", "to_numpy", "tree_leaves",
           "tree_map", "tree_map_with_path_names", "tree_paths",
           "tree_unflatten"]
