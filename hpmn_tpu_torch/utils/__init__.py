"""Shape and dtype checks at module boundaries (``asserts``)."""
