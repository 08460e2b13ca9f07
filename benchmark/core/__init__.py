"""The harness's core: nothing here knows any one cell."""
