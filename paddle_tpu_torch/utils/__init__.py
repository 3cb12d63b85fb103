"""Host utilities: named timers, the runtime flags the port reads, and
logging."""
