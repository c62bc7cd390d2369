"""The decoder-only attention LM: the port of `repro.models` for the
global ("g") and sliding-window ("l") attention kinds with the dense
gated MLP."""
