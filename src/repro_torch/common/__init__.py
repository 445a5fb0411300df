from repro_torch.common.tree import (
    flatten_to_vector,
    tree_add,
    tree_all_finite,
    tree_axpy,
    tree_cast,
    tree_dot,
    tree_norm,
    tree_scale,
    tree_size,
    tree_sq_norm,
    tree_sub,
    tree_weighted_sum,
    tree_zeros_like,
    unflatten_from_vector,
)
from repro_torch.common.sharding import (LogicalRules, logical_to_pspec,
                                         shard_pytree_spec,
                                         with_logical_constraint)
