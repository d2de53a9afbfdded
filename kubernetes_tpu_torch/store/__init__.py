"""L1 — the API store (versioned objects, watches, atomic binds, columnar
pod rows)."""

from .store import (  # noqa: F401
    ADDED,
    BOOKMARK,
    DELETED,
    MODIFIED,
    AlreadyBoundError,
    AlreadyExistsError,
    APIStore,
    CoalescedEvent,
    ConflictError,
    Event,
    is_bind_conflict,
    LazyBindBatch,
    LockOrderViolation,
    MutationDetectedError,
    MutationDetector,
    NotFoundError,
    pod_bind_clone,
    pod_structural_clone,
    ResourceVersionTooOldError,
    Watch,
)
