"""Plugin helpers the tensorizer shares with the (later) serial plugins, and
the victim-execution half of DefaultPreemption."""
