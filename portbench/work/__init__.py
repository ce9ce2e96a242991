"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of the work, counted from shapes."""
