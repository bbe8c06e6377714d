"""One traffic kind per module, found by the name its traffic file gives."""
