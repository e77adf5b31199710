"""PYMEVis GUI hooks: the skeletonization menu item.

Counterpart of the JAX package's
``visgui_modules/surface_feature_extraction.py``: ``Plug(visFr)``
registers "Mesh -> Skeletonize mesh" (the port's
``SkeletonizeMembrane`` recipe module).
"""


def skeletonize(visFr):
    from ..recipes.surface_feature_extraction import SkeletonizeMembrane

    surf_name = 'surf0'
    skel_name = visFr.pipeline.new_ds_name('skeleton')
    recipe = visFr.pipeline.recipe
    sk = SkeletonizeMembrane(input=surf_name, output=skel_name)
    if sk.configure_traits(kind='modal'):
        recipe.add_module(sk)
        recipe.execute()
        from PYME.LMVis.layers.mesh import TriangleRenderLayer
        layer = TriangleRenderLayer(visFr.pipeline, dsname=skel_name,
                                    method='wireframe')
        visFr.add_layer(layer)
        visFr.RefreshView()


def Plug(visFr):
    visFr.AddMenuItem('Mesh', 'Skeletonize mesh',
                      lambda e: skeletonize(visFr))
