"""recipe_s (program_span; layer: image recipe,
recipes.surface_fitting.ImageShrinkwrapMembrane): FitTrace kind
``recipe``, the recipe's own work before the fit (its repair and remesh
of the seed surface and the image's pseudo-localizations, children
inside its wall), seconds a fit; nothing for a fit without it."""

from benchmark.metrics._common import kinds, mean_per_fit

SOURCE = 'program_span'
LAYER = 'image recipe: recipes.surface_fitting.ImageShrinkwrapMembrane'


def read(run):
    return mean_per_fit(run, lambda f: kinds(f, 'recipe'))
