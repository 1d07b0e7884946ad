"""Host utilities: phase timers, the run record and its sinks, fault points, the env registry, logging, checkpoints."""
