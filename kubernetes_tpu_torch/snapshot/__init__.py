"""L3 — cluster snapshot -> dense tensors (class tables, PTS/IPA tensors)."""
