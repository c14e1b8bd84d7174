"""The port's search API: ``Retriever`` plus its request/response types."""

from repro_torch.api.backends import get_backend, list_backends, register_backend
from repro_torch.api.retriever import Retriever
from repro_torch.api.types import SearchRequest, SearchResponse
from repro_torch.core.config import (
    ConfigError,
    DynamicParams,
    RetrievalConfig,
    StaticConfig,
    combine,
    recommended_static,
)

__all__ = [
    "ConfigError",
    "DynamicParams",
    "RetrievalConfig",
    "Retriever",
    "SearchRequest",
    "SearchResponse",
    "StaticConfig",
    "combine",
    "get_backend",
    "list_backends",
    "recommended_static",
    "register_backend",
]
