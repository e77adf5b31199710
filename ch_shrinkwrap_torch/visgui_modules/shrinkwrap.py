"""PYMEVis GUI hooks: the shrinkwrap menu items.

Counterpart of the JAX package's ``visgui_modules/shrinkwrap.py``:
``Plug(visFr)`` registers "Mesh -> Shrinkwrap membrane surface" (the
port's ``ShrinkwrapMembrane`` recipe module) and "Mesh -> Show
shrinkwrap residuals".  PYME is imported only inside the handlers, and
the residual plot logs the histogram where matplotlib is absent.
"""

import logging

logger = logging.getLogger(__name__)

last_membrane = None


def shrinkwrap(visFr):
    from ..recipes.surface_fitting import ShrinkwrapMembrane
    global last_membrane

    surf_name = 'surf0'
    if surf_name not in visFr.pipeline.dataSources.keys():
        from PYME.LMVis.Extras.extra_layers import gen_isosurface
        gen_isosurface(visFr)

    membrane_name = visFr.pipeline.new_ds_name('membrane')
    recipe = visFr.pipeline.recipe
    sw = ShrinkwrapMembrane(input=surf_name, output=membrane_name,
                            points='filtered_localizations')
    if sw.configure_traits(kind='modal'):
        recipe.add_module(sw)
        recipe.execute()
        from PYME.LMVis.layers.mesh import TriangleRenderLayer
        layer = TriangleRenderLayer(visFr.pipeline, dsname=membrane_name,
                                    method='shaded')
        visFr.add_layer(layer)
        last_membrane = membrane_name
        visFr.RefreshView()


def show_residuals(visFr):
    mesh = visFr.pipeline.dataSources[last_membrane]
    counts, edges, pred = mesh.residual_histogram()
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        logger.info('residual histogram: %s', counts)
        return
    x = 0.5 * (edges[:-1] + edges[1:])
    f, a = plt.subplots()
    a.bar(x, counts, width=x[1] - x[0])
    if pred is not None:
        a.plot(x, pred, 'r', label='Predicted')
        a.legend()
    a.set_xlabel('Distance from surface [nm]')
    a.set_ylabel('Frequency')
    a.set_title('Surface residuals')
    f.show()


def Plug(visFr):
    visFr.AddMenuItem('Mesh', 'Shrinkwrap membrane surface',
                      lambda e: shrinkwrap(visFr))
    visFr.AddMenuItem('Mesh', 'Show shrinkwrap residuals',
                      lambda e: show_residuals(visFr))
