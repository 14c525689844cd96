"""Elle-style list-append checking on the device (inference + cycle
sweep + verdict bits)."""
