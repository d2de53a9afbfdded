"""L1 — the API store (versioned objects, watches, atomic binds)."""

from .store import (  # noqa: F401
    ADDED,
    DELETED,
    KINDS,
    MODIFIED,
    AlreadyBoundError,
    AlreadyExistsError,
    APIStore,
    CoalescedEvent,
    ConflictError,
    Event,
    NotFoundError,
    ResourceVersionTooOldError,
    Watch,
    pod_bind_clone,
    pod_structural_clone,
)
