from .app import AppGraph, AppInstance, Net  # noqa: F401
from .packing import pack                     # noqa: F401
from .global_place import global_place        # noqa: F401
from .detailed_place import detailed_place    # noqa: F401
from .route import RoutingResources, route_app, RoutingError  # noqa: F401
from .timing import sta_critical_path         # noqa: F401
from .driver import place_and_route, PnRResult  # noqa: F401
