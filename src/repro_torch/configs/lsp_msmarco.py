"""The paper's own system configuration (MS MARCO operating points, §5).

Not an "--arch" entry (those are the assigned pool); this records the recommended
index-build + query-time configurations used by benchmarks and the serve example.
"""

from repro_torch.core.config import RetrievalConfig
from repro_torch.index.builder import IndexBuildConfig

# index-build recommendations (paper §Conclusion): c=16, small b, 4-bit bounds, Fwd docs
INDEX_K10 = IndexBuildConfig(b=16, c=16, bound_bits=4, doc_bits=8)
INDEX_K1000 = IndexBuildConfig(b=8, c=16, bound_bits=4, doc_bits=8)

# zero-shot query-time configs (no grid search)
QUERY_K10 = RetrievalConfig(variant="lsp0", k=10, gamma=250, beta=0.33)
QUERY_K100 = RetrievalConfig(variant="lsp0", k=100, gamma=500, beta=0.33)
QUERY_K1000 = RetrievalConfig(variant="lsp0", k=1000, gamma=1000, beta=0.5)
