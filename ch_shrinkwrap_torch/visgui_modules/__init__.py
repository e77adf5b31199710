"""PYMEVis GUI hooks of the port: ``Plug(visFr)`` in each module
registers its menu items.  PYME is imported only inside the handlers."""
