from .clock import Clock, FakeClock  # noqa: F401
