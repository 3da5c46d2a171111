"""Host-side IR and the single-device cycle engine."""
