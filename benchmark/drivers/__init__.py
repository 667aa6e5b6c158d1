"""One driver a kind of traffic mix: ``run(spec) -> Outcome``."""
