"""The LM substrate: configuration, layers, attention, the transformer and
its prefill and decode steps.  Serving covers the dense GQA families
(``transformer.check_servable``)."""
