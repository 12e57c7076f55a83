"""Port of :mod:`repro.core.mapping`: the partition's and the portfolio
search's records, and the hyperedge traffic accounting
(:mod:`repro_torch.core.mapping.hypergraph`). The mapping strategies,
the search and the partitioners wait for a later slice (ROADMAP Queue A
item 7)."""
from repro_torch.core.mapping.books import PartitionResult
from repro_torch.core.mapping.search import CandidateTrace, SearchTrace

__all__ = ["CandidateTrace", "PartitionResult", "SearchTrace"]
