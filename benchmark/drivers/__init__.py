"""Driver kinds: one module a kind, found by the name a traffic mix gives."""
