"""The plain fp32 reference that decides ``correct``; it imports nothing
of the program."""
