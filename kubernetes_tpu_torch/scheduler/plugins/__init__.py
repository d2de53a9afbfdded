"""Plugin helpers the tensorizer shares with the (later) serial plugins."""
