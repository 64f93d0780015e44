"""Phone-side command relays: contacts lookup, call, SMS.

Mirrors ``app/lib/helper/commands.dart``: the glasses ask the phone (over
BLE) to resolve a contact, place a call, or send a text; the phone performs
the action through platform services and replies on the same channel as
``<command>|<auth_key>|<payload>``.

Reference behaviors kept exactly: the permission-denied reply string, the
"couldn't find any matching phone number / contact" messages, and the empty
acknowledgement payloads for ``call``/``text`` (commands.dart:12-50).
Reference defect NOT reproduced: ``contacts.firstWhere`` without ``orElse``
(commands.dart:17) throws ``StateError`` when no contact matches instead of
replying — here a missing contact yields the not-found reply the following
line clearly intended.

A copy of ``imagined_speech_translation_tpu.companion.phone`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Awaitable, Callable, Protocol, Sequence


@dataclass(frozen=True)
class Contact:
    display_name: str
    phones: tuple[str, ...] = ()


class PhoneServices(Protocol):
    """Platform capabilities the relays need (injectable for tests/hosts)."""

    async def request_contacts_permission(self) -> bool: ...

    async def get_contacts(self) -> Sequence[Contact]: ...

    async def dial(self, phone_number: str) -> None: ...

    async def send_sms(self, message: str, recipients: Sequence[str]) -> None: ...


@dataclass
class InMemoryPhone:
    """Fake phone for tests and headless demos; records every action."""

    contacts: tuple[Contact, ...] = ()
    contacts_permission: bool = True
    calls: list[str] = field(default_factory=list)
    sms: list[tuple[str, tuple[str, ...]]] = field(default_factory=list)

    async def request_contacts_permission(self) -> bool:
        return self.contacts_permission

    async def get_contacts(self) -> Sequence[Contact]:
        return self.contacts

    async def dial(self, phone_number: str) -> None:
        self.calls.append(phone_number)

    async def send_sms(self, message: str, recipients: Sequence[str]) -> None:
        self.sms.append((message, tuple(recipients)))


class PhoneActions:
    """Executes glasses-requested phone actions and writes the BLE reply."""

    def __init__(
        self,
        services: PhoneServices,
        auth_key: str,
        write_data: Callable[[str], Awaitable[None]],
    ):
        self.services = services
        self.auth_key = auth_key
        self.write_data = write_data

    async def contacts(self, name: str) -> None:
        message = f"contacts|{self.auth_key}|"
        if await self.services.request_contacts_permission():
            match = next(
                (
                    c
                    for c in await self.services.get_contacts()
                    if c.display_name.lower() == name.lower()
                ),
                None,
            )
            if match is not None and match.phones:
                message += match.phones[0]
            elif match is not None:
                message += (
                    f"I couldn't find any matching phone number with {name}"
                )
            else:
                message += f"I couldn't find any matching contact with {name}"
        else:
            message += "Please grant me permission to access your contacts"
        await self.write_data(message)

    async def call(self, phone_number: str) -> None:
        await self.services.dial(phone_number)
        await self.write_data(f"call|{self.auth_key}|")

    async def text(self, phone_number: str, message: str) -> None:
        await self.services.send_sms(message, [phone_number])
        await self.write_data(f"text|{self.auth_key}|")
