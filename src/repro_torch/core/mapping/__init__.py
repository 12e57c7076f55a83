"""Port of :mod:`repro.core.mapping`: the partition's and the portfolio
search's records. The mapping strategies and the search wait for the
compiler slice (ROADMAP Queue A item 7)."""
from repro_torch.core.mapping.books import PartitionResult
from repro_torch.core.mapping.search import CandidateTrace, SearchTrace

__all__ = ["CandidateTrace", "PartitionResult", "SearchTrace"]
