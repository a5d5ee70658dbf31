from repro_torch.ft.elastic import ElasticPlanner, FailureEvent, FailureInjector

__all__ = ["ElasticPlanner", "FailureEvent", "FailureInjector"]
