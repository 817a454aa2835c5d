"""Serving of the port: the batched engine (one replica,
``repro_torch.serving.engine``) and the Morpheus router across replicas
(``repro_torch.serving.router``).  Import each from its module: this
package imports neither, so importing it builds and loads no kernel."""
