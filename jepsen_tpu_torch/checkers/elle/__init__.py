"""Elle-style list-append and rw-register checking on the device
(inference + cycle sweep + verdict bits) and their checker APIs."""
