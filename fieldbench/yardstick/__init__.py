"""The yardstick: the card's published peaks and the operations and bytes
that a kernel's work needs, computed from shapes and the recorded body."""
