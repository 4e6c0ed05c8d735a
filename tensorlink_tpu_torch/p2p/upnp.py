"""UPnP-IGD port mapping, stdlib-only.

Public-network mode: when a node runs behind a NAT router, map its listen
port on the gateway so other peers can reach it (reference
smart_node.py:1200-1312, which uses the miniupnpc C extension — not in this
image, and the protocol is simple enough that a dependency buys nothing):

1. SSDP discovery — M-SEARCH datagram to 239.255.255.250:1900, parse the
   ``LOCATION`` header of the first InternetGatewayDevice response.
2. Fetch the device description XML; find the WANIPConnection (or
   WANPPPConnection) service's controlURL.
3. SOAP POST ``AddPortMapping`` / ``DeletePortMapping`` /
   ``GetExternalIPAddress`` to that URL.

Everything network-touching takes explicit addresses so tests can stand up
a fake IGD on 127.0.0.1 (no multicast, no real router).
"""

from __future__ import annotations

import socket
import urllib.request
from dataclasses import dataclass
from urllib.parse import urljoin, urlparse
from xml.etree import ElementTree

from tensorlink_tpu_torch.core.logging import get_logger

log = get_logger("p2p.upnp")

SSDP_ADDR = ("239.255.255.250", 1900)
IGD_SEARCH_TARGET = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
WAN_SERVICES = (
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)


class UPnPError(Exception):
    pass


@dataclass
class Gateway:
    control_url: str
    service_type: str


def discover_location(
    timeout: float = 2.0, ssdp_addr: tuple[str, int] = SSDP_ADDR
) -> str:
    """SSDP M-SEARCH; returns the LOCATION url of the first IGD response."""
    msg = (
        "M-SEARCH * HTTP/1.1\r\n"
        f"HOST: {ssdp_addr[0]}:{ssdp_addr[1]}\r\n"
        'MAN: "ssdp:discover"\r\n'
        "MX: 2\r\n"
        f"ST: {IGD_SEARCH_TARGET}\r\n\r\n"
    ).encode()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(msg, ssdp_addr)
        try:
            while True:
                data, _ = s.recvfrom(65507)
                for line in data.decode(errors="replace").splitlines():
                    if line.lower().startswith("location:"):
                        return line.split(":", 1)[1].strip()
        except socket.timeout:
            raise UPnPError("no IGD responded to SSDP discovery") from None


def fetch_gateway(location: str, timeout: float = 5.0) -> Gateway:
    """Parse the IGD device description; return the WAN*Connection control
    endpoint."""
    with urllib.request.urlopen(location, timeout=timeout) as r:
        tree = ElementTree.fromstring(r.read())
    # namespace-agnostic walk: {urn:...}serviceType etc.
    for svc in tree.iter():
        if not svc.tag.endswith("service"):
            continue
        stype = curl = None
        for child in svc:
            if child.tag.endswith("serviceType"):
                stype = (child.text or "").strip()
            elif child.tag.endswith("controlURL"):
                curl = (child.text or "").strip()
        if stype in WAN_SERVICES and curl:
            return Gateway(control_url=urljoin(location, curl), service_type=stype)
    raise UPnPError(f"no WAN*Connection service in {location}")


def _soap(gw: Gateway, action: str, args: dict[str, str], timeout: float = 5.0) -> str:
    body = "".join(f"<{k}>{v}</{k}>" for k, v in args.items())
    envelope = (
        '<?xml version="1.0"?>'
        '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/" '
        's:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
        f'<s:Body><u:{action} xmlns:u="{gw.service_type}">{body}</u:{action}>'
        "</s:Body></s:Envelope>"
    ).encode()
    req = urllib.request.Request(
        gw.control_url,
        data=envelope,
        headers={
            "Content-Type": 'text/xml; charset="utf-8"',
            "SOAPAction": f'"{gw.service_type}#{action}"',
        },
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read().decode(errors="replace")
    except urllib.error.HTTPError as e:  # IGD SOAP faults are HTTP 500
        raise UPnPError(f"{action} failed: {e.read().decode(errors='replace')[:200]}")


def local_ip_towards(gateway_url: str) -> str:
    """The local interface IP the gateway routes back to (what goes in
    NewInternalClient)."""
    host = urlparse(gateway_url).hostname or "8.8.8.8"
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((host, 80))
        return s.getsockname()[0]


def add_port_mapping(
    gw: Gateway,
    external_port: int,
    internal_port: int,
    internal_ip: str,
    protocol: str = "TCP",
    description: str = "tensorlink-tpu",
    lease_s: int = 0,
) -> None:
    _soap(gw, "AddPortMapping", {
        "NewRemoteHost": "",
        "NewExternalPort": str(external_port),
        "NewProtocol": protocol,
        "NewInternalPort": str(internal_port),
        "NewInternalClient": internal_ip,
        "NewEnabled": "1",
        "NewPortMappingDescription": description,
        "NewLeaseDuration": str(lease_s),
    })


def delete_port_mapping(gw: Gateway, external_port: int, protocol: str = "TCP") -> None:
    _soap(gw, "DeletePortMapping", {
        "NewRemoteHost": "",
        "NewExternalPort": str(external_port),
        "NewProtocol": protocol,
    })


def get_external_ip(gw: Gateway) -> str:
    resp = _soap(gw, "GetExternalIPAddress", {})
    tree = ElementTree.fromstring(resp)
    for el in tree.iter():
        if el.tag.endswith("NewExternalIPAddress"):
            return (el.text or "").strip()
    raise UPnPError("no NewExternalIPAddress in response")


class PortMapper:
    """Best-effort lifecycle wrapper: map on start, unmap on stop. Failure
    to find a gateway degrades to a warning — matching the reference, where
    UPnP failure doesn't kill the node (smart_node.py:1272-1286)."""

    def __init__(self, *, ssdp_addr: tuple[str, int] = SSDP_ADDR, timeout: float = 2.0):
        self.ssdp_addr = ssdp_addr
        self.timeout = timeout
        self.gateway: Gateway | None = None
        self.external_ip: str | None = None
        self.mapped: list[tuple[int, str]] = []

    def map_port(self, port: int, protocol: str = "TCP") -> str | None:
        """Map external ``port`` -> this host's ``port``. Returns the
        external IP, or None if no gateway is reachable."""
        try:
            if self.gateway is None:
                loc = discover_location(self.timeout, self.ssdp_addr)
                self.gateway = fetch_gateway(loc, self.timeout)
            ip = local_ip_towards(self.gateway.control_url)
            add_port_mapping(self.gateway, port, port, ip, protocol)
            self.mapped.append((port, protocol))
            self.external_ip = get_external_ip(self.gateway)
            log.info("upnp: mapped %s/%s -> %s:%s (external %s)",
                     port, protocol, ip, port, self.external_ip)
            return self.external_ip
        except (UPnPError, OSError, ElementTree.ParseError) as e:
            log.warning("upnp: port mapping unavailable: %s", e)
            return None

    def close(self) -> None:
        if self.gateway is None:
            return
        for port, protocol in self.mapped:
            try:
                delete_port_mapping(self.gateway, port, protocol)
            # tlint: disable=TL005(unmapping at close — the gateway may already be gone; mappings expire anyway)
            except (UPnPError, OSError):
                pass
        self.mapped.clear()


__all__ = [
    "Gateway", "PortMapper", "UPnPError", "add_port_mapping",
    "delete_port_mapping", "discover_location", "fetch_gateway",
    "get_external_ip",
]
