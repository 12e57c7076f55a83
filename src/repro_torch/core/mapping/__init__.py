"""Port of :mod:`repro.core.mapping`, the mapping search subsystem (paper
§6.2), numpy only:

#   books       flat occupancy bookkeeping (Eq. 9/10), batched
#   tree        partitioning-tree walk / path / LCA geometry, batched
#   search      vectorized restart population + portfolio search
#   strategies  the MappingStrategy registry behind compile(method=...)
#   hypergraph  greedy overlap partitioner, FM refinement, load balancing,
#               and the hyperedge traffic accounting
#   multilevel  coarsen - race coarse seeds - project - place - refine
#   legacy      the original pure-Python loop, kept as the parity reference

Every partitioner draws from explicit ``np.random.default_rng`` streams
and returns the reference's assignment bit for bit.
"""
from repro_torch.core.mapping.books import Books, PartitionResult
from repro_torch.core.mapping.legacy import partition_legacy
from repro_torch.core.mapping.search import (CandidateTrace, SearchConfig,
                                             SearchTrace, framework_partition,
                                             portfolio_search)
from repro_torch.core.mapping.strategies import (BaselineStrategy,
                                                 FrameworkStrategy,
                                                 MappingStrategy, STRATEGIES,
                                                 get_strategy,
                                                 register_strategy)
from repro_torch.core.mapping.tree import lca_depths, leaf_paths, walk

__all__ = [
    "Books", "PartitionResult", "partition_legacy",
    "CandidateTrace", "SearchConfig", "SearchTrace",
    "framework_partition", "portfolio_search",
    "BaselineStrategy", "FrameworkStrategy", "MappingStrategy",
    "STRATEGIES", "get_strategy", "register_strategy",
    "lca_depths", "leaf_paths", "walk",
]
