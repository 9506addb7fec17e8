from .association import (InstanceCounter, associate_observations,  # noqa: F401
                          associate_observations_optimal)  # noqa: F401
