from .hmm import NORMAL, RESTART, SKIP, viterbi_decode_batch
from .matcher import SegmentMatcher, resolve_device
from .params import MatchParams

__all__ = ["NORMAL", "RESTART", "SKIP", "viterbi_decode_batch",
           "SegmentMatcher", "resolve_device", "MatchParams"]
