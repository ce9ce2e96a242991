"""Online coupling surface: the wrappers and the TCP sidecar."""
