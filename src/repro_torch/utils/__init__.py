from repro_torch.utils.tree import (to_numpy, tree_leaves, tree_map,
                                    tree_paths, tree_unflatten)

__all__ = ["to_numpy", "tree_leaves", "tree_map", "tree_paths",
           "tree_unflatten"]
