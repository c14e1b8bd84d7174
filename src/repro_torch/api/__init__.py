"""The port's search API: ``Retriever`` plus its request/response types, and
the serving engine behind ``Retriever.serve``."""

from repro_torch.api.backends import get_backend, list_backends, register_backend
from repro_torch.api.retriever import Retriever
from repro_torch.api.types import SearchRequest, SearchResponse
from repro_torch.core.config import (
    ConfigError,
    DynamicParams,
    RetrievalConfig,
    StaticConfig,
    combine,
    recommended,
    recommended_static,
)

__all__ = [
    "ConfigError",
    "DynamicParams",
    "RetrievalConfig",
    "RetrievalEngine",
    "Retriever",
    "SearchRequest",
    "SearchResponse",
    "StaticConfig",
    "combine",
    "get_backend",
    "list_backends",
    "recommended",
    "recommended_static",
    "register_backend",
]


def __getattr__(name):
    # lazy: serve.engine imports api.types, so an eager import here would be circular
    if name == "RetrievalEngine":
        from repro_torch.serve.engine import RetrievalEngine

        return RetrievalEngine
    raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
